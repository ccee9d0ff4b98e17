"""Publication rendering of prediction or FEM GIFs, the port's
`gif_visualization.py`: the same flags, numpy and the standard library
only (no matplotlib, imageio or Pillow).

    python -m videometamaterials_tpu_torch.gif_visualization \
        --path runs/<name>/eval_target_w_5.0_0/step_<N>/gifs \
        --frame-ranges data/lagrangian/training/frame_range_data.csv \
        [--ref-frame lagrangian|eulerian] [--row R] [--col C] [--atol A]

writes <path>/visualization_<row>-<col>/ (stress_strain_estimate.csv,
visualization.gif, visualization_conv_euler.gif in the lagrangian frame,
visualization_legend.png) and prints the directory.
"""

from __future__ import annotations

import argparse

from videometamaterials_tpu_torch.postproc.visualization import (
    create_visualization,
)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", required=True,
                   help="directory containing prediction_channel_*.gif")
    p.add_argument("--frame-ranges", required=True,
                   help="frame_range_data.csv (training data) or the FEM "
                        "run's frame_range.csv")
    p.add_argument("--ref-frame", default="lagrangian",
                   choices=["lagrangian", "eulerian"])
    p.add_argument("--row", type=int, default=0,
                   help="conditioning index (grid row)")
    p.add_argument("--col", type=int, default=0,
                   help="prediction index (grid column)")
    p.add_argument("--atol", type=float, default=0.02)
    args = p.parse_args(argv)
    path = args.path if args.path.endswith("/") else args.path + "/"
    out = create_visualization(path, args.frame_ranges, args.row, args.col,
                               ref_frame=args.ref_frame, atol=args.atol)
    print(f"visualization written to {out}")
    return out


if __name__ == "__main__":
    main()
