#!/usr/bin/env python3
"""Time the port's temporal kernels and linear kernels of one tree.

Times, with CUDA events (chip_smoke.py's `cuda_ms`: 2 launches to warm,
then the mean of 5; the any-shape rows 1-3 and 8 1 and 3, rows 4-5 3 and
20), every shape that the sampling and training paths give
to the temporal forward (table row 1), the emit_p forward (row 2), the
temporal backward (row 3), the linear stats and apply (rows 4-5), the
linear backward (rows 6-7) and the head-layout linear forward (row 8), on
chip_smoke.py's seeded inputs, through the wrappers of the tree given by
--tree; and the any-shape instances of rows 1-8 at the largest shapes
of the three widths configurations of chip_smoke.py phase 13 (ANY_SHAPES;
rows 4-5 and 8 at wide's C = 1024 and at every heads4x64 level, row 8
also at the flagship's level 0 beside the specialised instance; rows 6-7
at heads4x64's levels at the training batch, wide's C = 1024 and the
flagship's level 0, beside the specialised instance there;
rows 1-3 also the specialised instance at the flagship's level-0 shape, the
same work as heads4x64's, and each plain twin). A tree whose
instance refuses a shape (row 8 off the flagship's shapes before it took
every shape) records the refusal. Prints one JSON line: the card (nvidia-smi's name and power
limit), the tree, and per row and shape the ms, the bound ms, the
achieved TFLOP/s and the share of the bound; with --profile also each CUDA
kernel's device time in one launch of each row at its level-0 shape (row
6 per-head at (44, 9216, 64), row 7 merged at (44, 2304, 128), row 8 at
(22, 9216, 64): its stats, merge and apply; rows 4-5 any-shape at
heads4x64's level 0 and wide's C = 1024; row 8 any-shape at heads4x64's
level 0, wide's C = 1024 and the flagship's level 0; rows 6-7 any-shape at heads4x64's
levels 0 and 1, wide's C = 1024 and the flagship's level 0) and rows 5
and 8's device
time a launch at every path shape. With row 5 it also digests
row 5's output at every path shape on one input seeded per shape
(`apply_digests`; row 5 any-shape's at its ANY_SHAPES, keyed
"any <config>"; with row 8 any-shape its outputs there, keyed "head any
<config>"), and with rows 1-3 their outputs (row 2: out and p; row
3: every cotangent) at every path shape (`temporal_digests`); --against
FILE compares them with the last line of an earlier run's --out FILE and
prints whether each is bit-equal. --outputs FILE keeps row 5
any-shape's outputs themselves: a run that finds FILE prints the share of
its bf16 outputs that differ in their bits from FILE's (and leaves it), a
run that does not writes it.

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
# the any-shape rows at the largest shapes of the widths configurations:
# rows 1-3 (B, F, S, C, T, heads, d), rows 2-3 at the training batch 4,
# row 8 (BF, N, C, Mc, heads, d) at heads4x64's four levels, and as
# "flagship" the flagship's level-0 shape (the any-shape instance called
# directly, beside the specialised one at the same work); tokens96's
# linear blocks take the specialised instance
ANY_SHAPES = {
    "temporal_fwd_any": [("wide", (2, 11, 144, 1024, 11, 8, 32)),
                         ("heads4x64", (2, 11, 9216, 64, 11, 4, 64)),
                         ("tokens96", (2, 11, 9216, 64, 96, 8, 32))],
    "temporal_fwd_p_any": [("wide", (4, 11, 144, 1024, 11, 8, 32)),
                           ("heads4x64", (4, 11, 9216, 64, 11, 4, 64)),
                           ("tokens96", (4, 11, 9216, 64, 96, 8, 32))],
    "linear_head_any": [("wide", (22, 144, 1024, 1, 8, 32)),
                        ("heads4x64", (22, 9216, 64, 1, 4, 32))] + [
        (f"heads4x64 L{i}", (22, n, c, 1, 4, 32)) for i, (n, c) in enumerate(
            ((2304, 128), (576, 256), (144, 512)), 1)] + [
        ("flagship", (22, 9216, 64, 1, 8, 32))],
}
ANY_SHAPES["temporal_bwd_any"] = ANY_SHAPES["temporal_fwd_p_any"]
# rows 4-5 (BF, N, C, Mc, heads, d): wide's C = 1024 and heads4x64's four
# levels (its linear blocks' 4 heads of 32)
ANY_SHAPES["linear_stats_any"] = [("wide", (22, 144, 1024, 1, 8, 32))] + [
    (f"heads4x64 L{i}", (22, n, c, 1, 4, 32)) for i, (n, c) in enumerate(
        ((9216, 64), (2304, 128), (576, 256), (144, 512)))]
ANY_SHAPES["linear_apply_any"] = ANY_SHAPES["linear_stats_any"]
# rows 6-7 (BF, N, C, Mc, heads, d) at the training batch 4 (44 folded
# frames), on the route each shape takes (`bwd_route`): row 6 (per-head)
# at heads4x64's level 0 and, as "flagship", the flagship's level-0 shape
# (the any-shape instance called directly, beside the specialised one at
# the same work); row 7 (merged) at heads4x64's levels 1-3 and wide's
# C = 1024
ANY_SHAPES["linear_bwd_head_any"] = [
    ("heads4x64 L0", (44, 9216, 64, 1, 4, 32)),
    ("flagship", (44, 9216, 64, 1, 8, 32))]
ANY_SHAPES["linear_bwd_merged_any"] = [
    (f"heads4x64 L{i}", (44, n, c, 1, 4, 32)) for i, (n, c) in enumerate(
        ((2304, 128), (576, 256), (144, 512)), 1)] + [
    ("wide", (44, 144, 1024, 1, 8, 32))]
LINEAR_BWD_ANY = ("linear_bwd_head_any", "linear_bwd_merged_any")


def _bwd_any_inputs(cs, name, shape, gen):
    """Rows 6-7 any-shape's operands at shape (chip_smoke.py phase 14's),
    its cotangent and keywords on the row's route."""
    import torch

    bf_, n, c, m_c, heads, d = shape
    a = cs._wtrain_linear_inputs(bf_, n, c, gen, m_c, heads, d)
    g = torch.randn(a["x"].shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    route = "head" if name == "linear_bwd_head_any" else "merged"
    kw = dict(heads=heads, scale=d ** -0.5, spatial_size=n, route=route)
    return a, g, kw


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
                    "(--out): print whether the digested outputs (rows 1-3 "
                    "and 5) are bit-equal to its last line's")
    ap.add_argument("--outputs", help="a .pt file of row 5 any-shape's "
                    "outputs: compared with (share of bit-different bf16 "
                    "elements) if it exists, else written")
    ap.add_argument("--rows", help="comma-separated rows to time (default "
                    "all): temporal_fwd, temporal_fwd_p, temporal_bwd, "
                    "linear_stats, linear_apply, linear_bwd, linear_head, "
                    "temporal_fwd_any, temporal_fwd_p_any, temporal_bwd_any, "
                    "linear_head_any, linear_stats_any, linear_apply_any, "
                    "linear_bwd_head_any, linear_bwd_merged_any")
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
                             "linear_head": [], **{k: [] for k in ANY_SHAPES}}

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

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            if t is not None:
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
        return h.hexdigest()

    fwd_shapes = sorted(set(cs.TEMPORAL_PATH) | set(cs.TRAIN_TEMPORAL),
                        key=lambda v: (-v[1], v[0], v[3]))
    t_digests: dict[str, str] = {}
    for b, s, c, t_tok in fwd_shapes:
        shape = (b, s, c, t_tok)
        d = cs.temporal_inputs(b, s, c, t_tok, torch.Generator(
            device="cuda").manual_seed(7))
        if "temporal_fwd" in want:
            t_digests[f"temporal_fwd {shape}"] = digest(
                tmp.temporal_block_fwd(**d, heads=cs.HEADS))
        if shape in cs.TRAIN_TEMPORAL and "temporal_fwd_p" in want:
            t_digests[f"temporal_fwd_p {shape}"] = digest(
                *tmp.temporal_block_fwd(**d, heads=cs.HEADS, emit_p=True))
        if shape in cs.TRAIN_TEMPORAL and "temporal_bwd" in want:
            g = torch.randn(d["x"].shape, generator=torch.Generator(
                device="cuda").manual_seed(8), device="cuda").to(
                torch.bfloat16)
            t_digests[f"temporal_bwd {shape}"] = digest(
                *tmp.temporal_block_bwd(**d, g=g, heads=cs.HEADS))
            del g
        del d
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
    any_out = {}
    if "linear_apply_any" in want:
        for config, (bf_, n, c, m_c, heads, d) in ANY_SHAPES[
                "linear_apply_any"]:
            a = cs.linear_inputs(bf_, n, c, torch.Generator(
                device="cuda").manual_seed(5), m_c, heads, d)
            out = lin.linear_apply(a["x"], a["gamma"], a["w_qkv"],
                                   a["w_out"], a["out_bias"], a["ctx"],
                                   a["z"], heads=heads, scale=d ** -0.5)
            digests[f"any {config}"] = hashlib.sha256(
                out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            any_out[config] = out.cpu()
            del a, out
    if "linear_head_any" in want:
        # row 8 any-shape (its token sums shared with the old rows 6-7) on
        # one input seeded per shape
        for config, (bf_, n, c, m_c, heads, d) in ANY_SHAPES[
                "linear_head_any"]:
            a = cs.head_inputs(bf_, n, c, torch.Generator(
                device="cuda").manual_seed(5), m_c=m_c, heads=heads, d=d)
            out = lin._head_any(**a, heads=heads, scale=d ** -0.5,
                                spatial_size=n)
            digests[f"head any {config}"] = hashlib.sha256(
                out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            del a, out
    bits = None
    if args.outputs and any_out:
        path = Path(args.outputs)
        if path.exists():
            then = torch.load(path)
            bits = {k: (v.view(torch.int16) != then[k].view(torch.int16))
                    .float().mean().item() for k, v in any_out.items()}
            print("row 5 any-shape outputs, share of bf16 elements whose bits "
                  f"differ from {path}'s: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in bits.items()),
                  flush=True)
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save(any_out, path)
    del any_out
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
    for name, shapes in ANY_SHAPES.items():
        if name not in want:
            continue
        for config, shape in shapes:
            if name in ("linear_stats_any", "linear_apply_any"):
                bf_, n, c, m_c, heads, d = shape
                a = cs.linear_inputs(bf_, n, c, gen, m_c=m_c, heads=heads,
                                     d=d)
                sargs = (a["x"], a["gamma"], a["w_qkv"], a["ek"], a["ev"])
                aargs = (a["x"], a["gamma"], a["w_qkv"], a["w_out"],
                         a["out_bias"], a["ctx"], a["z"])
                skw = dict(heads=heads, spatial_size=n)
                akw_ = dict(heads=heads, scale=d ** -0.5)
                if name == "linear_stats_any":
                    run = lambda: lin.linear_stats(*sargs, **skw)
                    plain = lambda: lin.linear_stats_plain(*sargs, **skw)
                    cost = cs.stats_cost(bf_, n, c, m_c, heads=heads, d=d)
                else:
                    run = lambda: lin.linear_apply(*aargs, **akw_)
                    plain = lambda: lin.linear_apply_plain(*aargs, **akw_)
                    cost = cs.apply_cost(bf_, n, c, heads=heads, d=d)
                spec = None
            elif name == "linear_head_any":
                bf_, n, c, m_c, heads, d = shape
                a = cs.head_inputs(bf_, n, c, gen, m_c=m_c, heads=heads,
                                   d=d)
                kw = dict(heads=heads, scale=d ** -0.5, spatial_size=n)
                run = lambda: lin._head_any(**a, **kw)
                plain = lambda: lin.linear_block_head_plain(**a, **kw)
                cost = cs.head_cost(bf_, n, c, m_c, heads=heads, d=d,
                                    ctx_parts=3)
                spec = ((lambda: lin.linear_block_head(**a, **kw))
                        if config == "flagship" else None)
            elif name in LINEAR_BWD_ANY:
                bf_, n, c, m_c, heads, d = shape
                a, g, kw = _bwd_any_inputs(cs, name, shape, gen)
                ops = [a[k] for k in ("x", "gamma", "w_qkv", "w_out", "ek",
                                      "ev")]
                run = lambda: lin._bwd_any(*ops, g, **kw)
                plain = lambda: lin.linear_block_bwd_plain(**a, g=g, **kw)
                cost = cs.linear_bwd_cost(bf_, n, c, m_c, heads=heads, d=d)
                spec = ((lambda: lin.linear_block_bwd(**a, g=g, **kw))
                        if config == "flagship" else None)
            else:
                b, f, s, c, t_tok, heads, d = shape
                a = cs.temporal_inputs(b, s, c, t_tok, gen, f, heads, d)
                g = torch.randn(a["x"].shape, generator=gen,
                                device="cuda").to(torch.bfloat16)
                spec_a = cs.temporal_inputs(b, s, 64, 11, gen)
                if name == "temporal_fwd_any":
                    run = lambda: tmp.temporal_block_fwd(**a, heads=heads)
                    plain = lambda: tmp.temporal_block_plain(**a, heads=heads)
                    cost = cs.temporal_cost(b, s, c, t_tok, f, heads,
                                            heads * d)
                    spec = lambda: tmp.temporal_block_fwd(**spec_a,
                                                          heads=cs.HEADS)
                elif name == "temporal_fwd_p_any":
                    run = lambda: tmp.temporal_block_fwd(**a, heads=heads,
                                                         emit_p=True)
                    plain = lambda: tmp.temporal_block_plain_p(**a,
                                                               heads=heads)
                    cost = cs.temporal_p_cost(b, s, c, t_tok, f, heads,
                                              heads * d)
                    spec = lambda: tmp.temporal_block_fwd(
                        **spec_a, heads=cs.HEADS, emit_p=True)
                else:
                    run = lambda: tmp.temporal_block_bwd(**a, g=g,
                                                         heads=heads)
                    plain = lambda: tmp.temporal_block_bwd_plain(
                        **a, g=g, heads=heads)
                    cost = cs.temporal_bwd_cost(b, s, c, t_tok, f, heads,
                                                heads * d)
                    spec_g = torch.randn(spec_a["x"].shape, generator=gen,
                                         device="cuda").to(torch.bfloat16)
                    spec = lambda: tmp.temporal_block_bwd(
                        **spec_a, g=spec_g, heads=cs.HEADS)
            try:
                run()
            except ValueError as e:
                rows[name].append(dict(config=config, shape=list(shape),
                                       refused=str(e)))
                continue
            # rows 4-5 take tens of microseconds: more launches a mean
            fast = name in ("linear_stats_any", "linear_apply_any")
            e = timed(name, shape, run, cost, reps=20 if fast else 3,
                      warmup=3 if fast else 1)
            e["config"] = config
            if spec is not None and config in ("heads4x64", "flagship"):
                e["specialised_ms"] = cs.cuda_ms(spec, reps=3, warmup=1)
            e["plain_ms"] = cs.cuda_ms(plain, reps=1, warmup=1)
            del a
            torch.cuda.empty_cache()
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
        # the any-shape rows: one launch at heads4x64's level-0 shape (row
        # 3 also at tokens96's)
        for name, config in (("temporal_fwd_any", "heads4x64"),
                             ("temporal_fwd_p_any", "heads4x64"),
                             ("temporal_bwd_any", "heads4x64"),
                             ("temporal_bwd_any", "tokens96"),
                             ("linear_head_any", "heads4x64"),
                             ("linear_head_any", "wide"),
                             ("linear_head_any", "flagship"),
                             ("linear_stats_any", "heads4x64 L0"),
                             ("linear_stats_any", "wide"),
                             ("linear_apply_any", "heads4x64 L0"),
                             ("linear_apply_any", "wide"),
                             ("linear_bwd_head_any", "heads4x64 L0"),
                             ("linear_bwd_head_any", "flagship"),
                             ("linear_bwd_merged_any", "heads4x64 L1"),
                             ("linear_bwd_merged_any", "wide")):
            if name not in want:
                continue
            shape = dict(ANY_SHAPES[name])[config]
            if name in ("linear_stats_any", "linear_apply_any"):
                bf_, n, c, m_c, heads, d = shape
                a = cs.linear_inputs(bf_, n, c, gen, m_c=m_c, heads=heads,
                                     d=d)
                run = ((lambda: lin.linear_stats(
                           a["x"], a["gamma"], a["w_qkv"], a["ek"], a["ev"],
                           heads=heads, spatial_size=n))
                       if name == "linear_stats_any" else
                       (lambda: lin.linear_apply(
                           a["x"], a["gamma"], a["w_qkv"], a["w_out"],
                           a["out_bias"], a["ctx"], a["z"], heads=heads,
                           scale=d ** -0.5)))
            elif name == "linear_head_any":
                bf_, n, c, m_c, heads, d = shape
                a = cs.head_inputs(bf_, n, c, gen, m_c=m_c, heads=heads,
                                   d=d)
                run = lambda: lin._head_any(
                    **a, heads=heads, scale=d ** -0.5, spatial_size=n)
            elif name in LINEAR_BWD_ANY:
                a, g, kw = _bwd_any_inputs(cs, name, shape, gen)
                ops = [a[k] for k in ("x", "gamma", "w_qkv", "w_out", "ek",
                                      "ev")]
                run = lambda: lin._bwd_any(*ops, g, **kw)
            else:
                b, f, s, c, t_tok, heads, d = shape
                a = cs.temporal_inputs(b, s, c, t_tok, gen, f, heads, d)
                g = torch.randn(a["x"].shape, generator=gen,
                                device="cuda").to(torch.bfloat16)
                run = {"temporal_fwd_any": lambda: tmp.temporal_block_fwd(
                           **a, heads=heads),
                       "temporal_fwd_p_any": lambda: tmp.temporal_block_fwd(
                           **a, heads=heads, emit_p=True),
                       "temporal_bwd_any": lambda: tmp.temporal_block_bwd(
                           **a, g=g, heads=heads)}[name]
            try:
                run()
            except ValueError:
                continue
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            stages[f"{name} {config}"] = _device_ms(prof)
            del a
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
    equal = t_equal = None
    if args.against:
        lines = Path(args.against).read_text().splitlines()
        then = json.loads(lines[-1])
        equal = {k: then["apply_digests"].get(k) == v
                 for k, v in digests.items()}
        t_equal = {k: then.get("temporal_digests", {}).get(k) == v
                   for k, v in t_digests.items()}
        print(f"rows 5 and 8 any outputs bit-equal to {then['tree']}'s "
              f"at {sum(equal.values())} of {len(equal)} path shapes: "
              + ", ".join(f"{k} {v}" for k, v in equal.items()), flush=True)
        print(f"rows 1-3 outputs bit-equal to {then['tree']}'s at "
              f"{sum(t_equal.values())} of {len(t_equal)} row shapes: "
              + ", ".join(f"{k} {v}" for k, v in t_equal.items()), flush=True)
    line = json.dumps({"card": smi, "tree": str(tree), "nvcc_s": build_s,
                       "rows": rows, "stages_ms": stages,
                       "apply_digests": digests, "apply_bit_equal": equal,
                       "apply_any_bits_differ": bits,
                       "temporal_digests": t_digests,
                       "temporal_bit_equal": t_equal})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
