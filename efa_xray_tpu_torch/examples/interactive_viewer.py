#!/usr/bin/env python
"""Interactive EFA viewer — the live twin of ``efa_demo.ipynb`` cells 14-16.

Port of ``examples/interactive_viewer.py``: with a GUI matplotlib backend
(or in a notebook with ipywidgets) you get live sliders for observation
count / error / inflation; headless, pass ``--save out.png`` to render one
frame.  It needs matplotlib; the point assimilation behind each frame runs
on ``--device``.

Run: ``python -m efa_xray_tpu_torch.examples.interactive_viewer
[--save viewer.png] [--device cpu]``
"""

import argparse

from efa_xray_tpu_torch.utils.demo import add_device_arg, apply_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", default=None, help="render headless to a PNG")
    ap.add_argument("--n-obs", type=int, default=5)
    ap.add_argument("--ob-error", type=float, default=1.0)
    ap.add_argument("--inflation", type=float, default=1.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = apply_device(args)
    return args


def plot(args):
    """The viewer (matplotlib), saved to ``--save`` when given."""
    import matplotlib

    if args.save:
        matplotlib.use("Agg")
    from efa_xray_tpu_torch.postprocess.viewer import assimilation_viewer

    viewer = assimilation_viewer(
        n_obs=args.n_obs, ob_error=args.ob_error, inflation=args.inflation,
        device=args.device,
    )
    if args.save:
        viewer.save(args.save)
        print(f"saved {args.save}")
    return viewer


def main(argv=None):
    args = parse_args(argv)
    plot(args)
    if not args.save:
        import matplotlib.pyplot as plt

        plt.show()


if __name__ == "__main__":
    main()
