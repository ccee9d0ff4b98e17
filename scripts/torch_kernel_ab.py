#!/usr/bin/env python3
"""Time the port's temporal kernels and linear kernels of one tree.

Times, with CUDA events (chip_smoke.py's `cuda_ms`: 2 launches to warm,
then the mean of 5), every shape that the sampling and training paths give
to the temporal forward (table row 1), the emit_p forward (row 2), the
temporal backward (row 3), the linear stats and apply (rows 4-5), the
linear backward (rows 6-7) and the head-layout linear forward (row 8), on
chip_smoke.py's seeded inputs, through the wrappers of the tree given by
--tree. Prints one JSON line: the card (nvidia-smi's name and power
limit), the tree, and per row and shape the ms, the bound ms, the
achieved TFLOP/s and the share of the bound; with --profile also each CUDA
kernel's device time in one launch of each row at its level-0 shape (row
6 per-head at (44, 9216, 64), row 7 merged at (44, 2304, 128), row 8 at
(22, 9216, 64): its stats, merge and apply) and rows 5 and 8's device
time a launch at every path shape. With row 5 it also digests
row 5's output at every path shape on one input seeded per shape
(`apply_digests`); --against FILE compares them with the last line of an
earlier run's --out FILE and prints whether each is bit-equal.

To compare two versions on one card, unpack the other one's port into a
gitignored directory that the copy to the card keeps (`git archive
<commit> videometamaterials_tpu_torch | tar -x -C chip_archive/parent`)
and run, in one call on the card: parent, this tree, this tree, parent:

    python3 scripts/torch_kernel_ab.py --tree chip_archive/parent
    python3 scripts/torch_kernel_ab.py --tree .

Each tree builds its own kernels into its own build/ at first use. The
shapes, inputs, costs and bounds are this tree's chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(prof) -> dict:
    """Device ms of each CUDA kernel in a torch.profiler trace."""
    import torch

    return {e.key[:90]: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose kernels to time")
    ap.add_argument("--out", help="also append the JSON line to this file")
    ap.add_argument("--profile", action="store_true",
                    help="also print the device time of each CUDA kernel in "
                         "one launch of each row at its level-0 shape "
                         "(torch.profiler)")
    ap.add_argument("--against", help="a JSON-lines file of an earlier run "
                    "(--out): print whether row 5's outputs are bit-equal "
                    "to its last line's")
    ap.add_argument("--rows", help="comma-separated rows to time (default "
                    "all): temporal_fwd, temporal_fwd_p, temporal_bwd, "
                    "linear_stats, linear_apply, linear_bwd, linear_head")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", flush=True)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    cs = _chip_smoke()
    from videometamaterials_tpu_torch.ops.cuda import _build
    from videometamaterials_tpu_torch.ops.cuda import fused_linear_block as lin
    from videometamaterials_tpu_torch.ops.cuda import fused_temporal_block as tmp

    assert Path(tmp.__file__).resolve().is_relative_to(tree), tmp.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    build_s = _build.build_info()["seconds"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows: dict[str, list] = {"temporal_fwd": [], "temporal_fwd_p": [],
                             "temporal_bwd": [], "linear_stats": [],
                             "linear_apply": [], "linear_bwd": [],
                             "linear_head": []}

    want = set(args.rows.split(",")) if args.rows else set(rows)
    if want - set(rows):
        ap.error(f"unknown rows {sorted(want - set(rows))}")

    def timed(name, shape, fn, cost, **kw):
        """Time fn at shape into rows[name] if that row is asked for."""
        if name not in want:
            return None
        ms = cs.cuda_ms(fn, **kw)
        bms, by = cs.bound(*cost)
        rows[name].append(dict(shape=list(shape), ms=ms, bound_ms=bms,
                               bound_by=by, tflops=sum(cost[1:]) / ms * 1e-9,
                               bound_share=bms / ms))
        return rows[name][-1]

    fwd_shapes = sorted(set(cs.TEMPORAL_PATH) | set(cs.TRAIN_TEMPORAL),
                        key=lambda v: (-v[1], v[0], v[3]))
    for b, s, c, t_tok in fwd_shapes:
        shape = (b, s, c, t_tok)
        a = cs.temporal_inputs(b, s, c, t_tok, gen)
        timed("temporal_fwd", shape,
              lambda: tmp.temporal_block_fwd(**a, heads=cs.HEADS),
              cs.temporal_cost(*shape))
        if shape in cs.TRAIN_TEMPORAL:
            timed("temporal_fwd_p", shape, lambda: tmp.temporal_block_fwd(
                **a, heads=cs.HEADS, emit_p=True), cs.temporal_p_cost(*shape))
            g = torch.randn(a["x"].shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            timed("temporal_bwd", shape, lambda: tmp.temporal_block_bwd(
                **a, g=g, heads=cs.HEADS), cs.temporal_bwd_cost(*shape),
                reps=3, warmup=1)
        del a
    akw = dict(heads=cs.HEADS, scale=32 ** -0.5)
    digests = {}
    for bf_, n, c in sorted(set(cs.LINEAR_PATH) | set(cs.TRAIN_LINEAR),
                            key=lambda v: (-v[1], v[0])):
        if "linear_apply" in want:
            a = cs.linear_inputs(bf_, n, c, torch.Generator(
                device="cuda").manual_seed(5))
            out = lin.linear_apply(a["x"], a["gamma"], a["w_qkv"],
                                   a["w_out"], a["out_bias"], a["ctx"],
                                   a["z"], **akw)
            digests[str((bf_, n, c))] = hashlib.sha256(
                out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            del a, out
        a = cs.linear_inputs(bf_, n, c, gen)
        timed("linear_stats", (bf_, n, c), lambda: lin.linear_stats(
            a["x"], a["gamma"], a["w_qkv"], a["ek"], a["ev"],
            heads=cs.HEADS, spatial_size=n), cs.stats_cost(bf_, n, c))
        timed("linear_apply", (bf_, n, c), lambda: lin.linear_apply(
            a["x"], a["gamma"], a["w_qkv"], a["w_out"], a["out_bias"],
            a["ctx"], a["z"], **akw), cs.apply_cost(bf_, n, c))
        del a
        a = cs.head_inputs(bf_, n, c, gen)
        timed("linear_head", (bf_, n, c), lambda: lin.linear_block_head(
            **a, **akw, spatial_size=n), cs.head_cost(bf_, n, c))
        del a
    for bf_, n, c in sorted(set(cs.TRAIN_LINEAR), key=lambda v: -v[1]):
        a = cs.linear_inputs(bf_, n, c, gen)
        del a["ctx"], a["z"]
        g = torch.randn(a["x"].shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        route = lin.bwd_route(n)
        kw = dict(heads=cs.HEADS, scale=32 ** -0.5, spatial_size=n,
                  route=route)
        e = timed("linear_bwd", (bf_, n, c),
                  lambda: lin.linear_block_bwd(**a, g=g, **kw),
                  cs.linear_bwd_cost(bf_, n, c), reps=3, warmup=1)
        if e is not None:
            e["route"] = route
        del a
    stages = {}
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        for name, (b, s, c, t_tok), run in (
                ("temporal_fwd", (2, 9216, 64, 11), lambda a, g: (
                    tmp.temporal_block_fwd(**a, heads=cs.HEADS))),
                ("temporal_fwd_p", (4, 9216, 64, 11), lambda a, g: (
                    tmp.temporal_block_fwd(**a, heads=cs.HEADS, emit_p=True))),
                ("temporal_bwd", (4, 9216, 64, 11), lambda a, g: (
                    tmp.temporal_block_bwd(**a, g=g, heads=cs.HEADS)))):
            if name not in want:
                continue
            a = cs.temporal_inputs(b, s, c, t_tok, gen)
            g = torch.randn(a["x"].shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            run(a, g)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(a, g)
                torch.cuda.synchronize()
            stages[name] = _device_ms(prof)
            del a, g
        a = cs.linear_inputs(22, 9216, 64, gen)
        h = cs.head_inputs(22, 9216, 64, gen)
        b6 = cs.linear_inputs(44, 9216, 64, gen)
        b7 = cs.linear_inputs(44, 2304, 128, gen)
        g6 = torch.randn(b6["x"].shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        g7 = torch.randn(b7["x"].shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        for t in (b6, b7):
            del t["ctx"], t["z"]

        def bwd(t, g, n):
            kw = dict(heads=cs.HEADS, scale=32 ** -0.5, spatial_size=n,
                      route=lin.bwd_route(n))
            return lambda: lin.linear_block_bwd(**t, g=g, **kw)

        for name, row, run in (
                ("linear_stats", "linear_stats", lambda: lin.linear_stats(
                    a["x"], a["gamma"], a["w_qkv"], a["ek"], a["ev"],
                    heads=cs.HEADS, spatial_size=9216)),
                ("linear_apply", "linear_apply", lambda: lin.linear_apply(
                    a["x"], a["gamma"], a["w_qkv"], a["w_out"],
                    a["out_bias"], a["ctx"], a["z"], **akw)),
                ("linear_bwd_head", "linear_bwd", bwd(b6, g6, 9216)),
                ("linear_bwd_merged", "linear_bwd", bwd(b7, g7, 2304)),
                ("linear_head", "linear_head", lambda: lin.linear_block_head(
                    **h, **akw, spatial_size=9216))):
            if row not in want:
                continue
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            stages[name] = _device_ms(prof)
        del a, h, b6, b7, g6, g7
        # rows 5 and 8 at every path shape: the device time of a launch,
        # which at the small shapes the host's launch overhead hides from
        # the event times
        by_shape = {}
        for bf_, n, c in sorted(set(cs.LINEAR_PATH) | set(cs.TRAIN_LINEAR),
                                key=lambda v: (-v[1], v[0])):
            for row, make, run in (
                    ("linear_apply", cs.linear_inputs, lambda: lin.linear_apply(
                        a["x"], a["gamma"], a["w_qkv"], a["w_out"],
                        a["out_bias"], a["ctx"], a["z"], **akw)),
                    ("linear_head", cs.head_inputs,
                     lambda: lin.linear_block_head(**a, **akw,
                                                   spatial_size=n))):
                if row not in want:
                    continue
                a = make(bf_, n, c, gen)
                run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        run()
                    torch.cuda.synchronize()
                by_shape.setdefault(row, {})[str((bf_, n, c))] = sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                ) / 5e3
                del a
        stages["device_ms_a_launch"] = by_shape
    equal = None
    if args.against:
        lines = Path(args.against).read_text().splitlines()
        then = json.loads(lines[-1])
        equal = {k: then["apply_digests"].get(k) == v
                 for k, v in digests.items()}
        print(f"row 5 (linear_apply) outputs bit-equal to {then['tree']}'s "
              f"at {sum(equal.values())} of {len(equal)} path shapes: "
              + ", ".join(f"{k} {v}" for k, v in equal.items()), flush=True)
    line = json.dumps({"card": smi, "tree": str(tree), "nvcc_s": build_s,
                       "rows": rows, "stages_ms": stages,
                       "apply_digests": digests, "apply_bit_equal": equal})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
