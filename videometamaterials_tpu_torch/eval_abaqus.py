"""FEM verification entry point of the port.

    python -m videometamaterials_tpu_torch.eval_abaqus
        [--samples-path runs/pretrained/eval_target_w_5.0_0/step_200000/]
        [--sample-index 0] [--sample-grf] [--no-gifs]
        [--gif-reference-frame eulerian|lagrangian] [--pixels 48]

The JAX package's root eval_abaqus.py with the same flags: runs Abaqus CAE
(`abaqus cae noGUI=...`, which must be on the PATH) on the port's model
builder for one row of an eval directory's geometries.csv (or a fresh GRF
geometry with --sample-grf) in <samples-path>/abaqus_eval_sample_<i>/,
then converts the solver's per-frame field CSVs to channel GIFs and
frame_range.csv in its gif/ folder.
"""

from __future__ import annotations

import argparse

from videometamaterials_tpu_torch.fem.eval_abaqus import evaluate_sample


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--samples-path",
                   default="runs/pretrained/eval_target_w_5.0_0/step_200000/")
    p.add_argument("--sample-index", type=int, default=0)
    p.add_argument("--sample-grf", action="store_true",
                   help="evaluate a random GRF geometry instead")
    p.add_argument("--no-gifs", action="store_true")
    p.add_argument("--gif-reference-frame", default="eulerian",
                   choices=["eulerian", "lagrangian"])
    p.add_argument("--pixels", type=int, default=48)
    return p


def main(argv=None, abaqus_runner=None):
    """Run the CLI; abaqus_runner(cmd, cwd) replaces the shell call."""
    args = _parser().parse_args(argv)
    return evaluate_sample(
        samples_path=args.samples_path,
        sample_index=args.sample_index,
        sample_grf=args.sample_grf,
        create_gifs=not args.no_gifs,
        gif_reference_frame=args.gif_reference_frame,
        pixels=args.pixels,
        abaqus_runner=abaqus_runner,
    )


if __name__ == "__main__":
    main()
