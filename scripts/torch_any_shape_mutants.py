"""Mutation check of chip_smoke.py phases 13 (a), 14 (a) and 15 (a): ten
copies of the port under OUT_DIR, each with one deliberate fault in one
any-shape instance (row 2's p halved, row 3's dbias dropped, row 4's last
ragged token sub-tile dropped, row 5's padded head columns counted in the
softmax sum, row 6's S term dropped, row 7's clip dropped, rows 6-7's
padded head columns counted in the query softmax's sum, row 8's lo part
of oh dropped, its running max not rescaled, its padded head columns
counted in the q softmax), built side by side; each copy's phase check
(`chip_smoke.wlinear_kernels` for rows 4-5, `chip_smoke.whead_kernels`
for row 8, `chip_smoke.wtrain_kernels` for the rest) must raise. Exits
non-zero if one does not.

Run on one GPU from the root of a checkout, OUT_DIR a directory outside
its sources (the copies build there):

    python scripts/torch_any_shape_mutants.py build/mutants
"""
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "videometamaterials_tpu_torch/ops/cuda/csrc/"
# name: (source, the text replaced once, its replacement, the check)
MUTANTS = {
    # row 2: p written at half its value (out untouched)
    "row2_p_halved": (CSRC + "any_shape.cu",
                      "__float2bfloat16(pr[nt][2 * half + e]);",
                      "__float2bfloat16(0.5f * pr[nt][2 * half + e]);",
                      "wtrain_kernels"),
    # row 3: dbias dropped
    "row3_no_dbias": (CSRC + "any_shape_bwd.cu",
                      "dbw[i * gp + j] += ds[nt][2 * half + e];",
                      "dbw[i * gp + j] += 0.f;", "wtrain_kernels"),
    # row 4: a tile's last sub-tile dropped where it is ragged (N = 144:
    # tiles of 64, 64 and 16 tokens)
    "row4_no_ragged_subtile": (
        CSRC + "any_shape.cu",
        "const int n_sub = (n_end - n_begin + kLinStatM - 1) / kLinStatM;",
        "const int n_sub = (n_end - n_begin) / kLinStatM;",
        "wlinear_kernels"),
    # row 5: a head's padded columns (d = 40 and 20 pad to 48 and 32)
    # counted in its feature softmax's sum
    "row5_pad_in_softmax": (CSRC + "any_shape.cu",
                            "return in_head ? expf(q - m) : 0.f;",
                            "return expf(q - m);", "wlinear_kernels"),
    # row 6 (per-head, clip 0): the softmax's S term dropped from dk
    "row6_no_S": (CSRC + "any_linear_bwd.cu",
                  "dk[e] = pass ? pval * (o[n][e] - sh[col]) : 0.f;",
                  "dk[e] = pass ? pval * (o[n][e] - (clip ? sh[col] : 0.f))"
                  " : 0.f;", "wtrain_kernels"),
    # row 7 (merged, clip 1): dk no longer zero where |k| >= 60
    "row7_no_clip": (CSRC + "any_linear_bwd.cu",
                     "const bool pass = ok && (!clip || fabsf(k) < kClamp);",
                     "const bool pass = ok;", "wtrain_kernels"),
    # rows 6-7: a head's padded columns (d = 40 pads to 48) counted in its
    # query softmax's sum
    "row67_pad_in_softmax": (CSRC + "any_linear_bwd.cu",
                             "return in_head ? expf(q - m) : 0.f;",
                             "return expf(q - m);", "wtrain_kernels"),
    # row 8: oh meets W_out as its bf16 hi part alone (seen at x times
    # 0.01, HEAD_BITS)
    "row8_no_lo": (CSRC + "any_linear_head_apply.cu",
                   "(lrow + 8 * h8 * ohp + n * 8) = lo_bf16x2(a, b);",
                   "(lrow + 8 * h8 * ohp + n * 8) = 0u;", "whead_kernels"),
    # row 8: ctx and z not rescaled where the running max rises (seen at
    # N = 9216, tiles of four sub-tiles, |k| across 60)
    "row8_no_rescale": (CSRC + "any_linear_head.cu",
                        "return expf(mold[col] - m_new(col));",
                        "return 1.f;", "whead_kernels"),
    # row 8: a head's padded columns (d = 40 pads to 48) counted in its q
    # softmax's sum
    "row8_pad_in_softmax": (CSRC + "any_linear_head_apply.cu",
                            "return pad ? 0.f : expf(q - m);",
                            "return expf(q - m);", "whead_kernels"),
}
# run inside a copy: the mutant's phase check must raise AssertionError
CHECK = """import sys, tempfile
from pathlib import Path
import chip_smoke as cs
from videometamaterials_tpu_torch.ops.cuda import _build
report = {k: {} for k in _build.LAUNCH_COUNTS}
try:
    cs.%s(report, Path(tempfile.mkdtemp(dir='.')))
except AssertionError as e:
    print('CAUGHT', str(e)[:300])
    sys.exit(0)
print('NOT CAUGHT')
sys.exit(1)
"""


def make_copy(out: Path, name: str) -> subprocess.Popen:
    """The mutant's copy (the package, chip_smoke.py, model.yaml) with its
    fault, and its build started."""
    path, old, new, _ = MUTANTS[name]
    d = out / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shutil.copytree(ROOT / "videometamaterials_tpu_torch",
                    d / "videometamaterials_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d)
    shutil.copy(ROOT / "model.yaml", d)
    src = (d / path).read_text()
    if src.count(old) != 1:
        sys.exit(f"{name}: the mutation's anchor is not in {path} once")
    (d / path).write_text(src.replace(old, new))
    return subprocess.Popen(
        [sys.executable, "-c", "from videometamaterials_tpu_torch.ops.cuda "
         "import _build; _build.build_info()"], cwd=d)


def main(out: Path) -> int:
    t0 = time.time()
    builds = {name: make_copy(out, name) for name in MUTANTS}
    for name, proc in builds.items():
        if proc.wait() != 0:
            sys.exit(f"{name}: build failed")
    print(f"{len(builds)} mutant builds in {time.time() - t0:.1f}s",
          flush=True)
    missed = []
    for name in MUTANTS:
        t0 = time.time()
        run = subprocess.run([sys.executable, "-c",
                              CHECK % MUTANTS[name][3]], cwd=out / name,
                             capture_output=True, text=True)
        line = [s for s in run.stdout.splitlines() if "CAUGHT" in s]
        print(f"{name}: "
              f"{line[-1] if line else run.stdout[-300:] + run.stderr[-500:]}"
              f" ({time.time() - t0:.1f}s)", flush=True)
        if run.returncode != 0:
            missed.append(name)
    if missed:
        print(f"not caught: {missed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(Path(sys.argv[1])))
