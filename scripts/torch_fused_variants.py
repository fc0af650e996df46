"""Tile / stage / occupancy variants of the fused_metrics tile kernel, each
built from a copy of csrc/kernels.cu with FM_TILE, FM_STAGES, FM_QB and
the launch bounds' CTAs per SM substituted, checked == the plain version
and timed (CUDA events; profiler device time of the tile kernel and of
the fold) at B = 1 and 128, minmax off and on, on random masks over the
bench's 10,027,008 rows. Needs one CUDA card.

    python3 scripts/torch_fused_variants.py
"""
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import kernels as K  # noqa: E402

#: name -> substituted constants (LB: CTAs per SM in the launch bounds)
VARIANTS = {
    "t2048 s4 lb3": {"FM_TILE": 2048, "FM_STAGES": 4, "LB": 3},
    "t4096 s3 lb3": {"FM_TILE": 4096, "FM_STAGES": 3, "LB": 3},
    "t2048 s6 lb3": {"FM_TILE": 2048, "FM_STAGES": 6, "LB": 3},
    "t1024 s8 lb3": {"FM_TILE": 1024, "FM_STAGES": 8, "LB": 3},
    "t2048 s4 lb4": {"FM_TILE": 2048, "FM_STAGES": 4, "LB": 4},
    "t2048 s3 lb4 qb256": {"FM_TILE": 2048, "FM_STAGES": 3, "LB": 4,
                           "FM_QB": 256},
}


def variant_source(sub):
    s = K._SRC.read_text()
    for k in ("FM_TILE", "FM_STAGES", "FM_QB"):
        if k in sub:
            s, n = re.subn(rf"constexpr int {k} = \d+;",
                           f"constexpr int {k} = {sub[k]};", s)
            assert n == 1, k
    if "LB" in sub:
        s, n = re.subn(r"__launch_bounds__\(FM_THREADS, \d\)",
                       f"__launch_bounds__(FM_THREADS, {sub['LB']})", s)
        assert n == 1
    return s


def build(i, name, sub):
    d = REPO / "build" / "fm_variants"
    d.mkdir(parents=True, exist_ok=True)
    src = d / f"v{i}.cu"
    src.write_text(variant_source(sub))
    so = d / f"libv{i}.so"
    res = subprocess.run([K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-Xptxas", "-v", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    regs = [ln.strip() for ln in res.stderr.splitlines() if "registers" in ln]
    return name, sub, so, regs


def main():
    card = S.phase_versions(torch, K)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda a: build(*a),
                            [(i, n, v) for i, (n, v) in
                             enumerate(VARIANTS.items())]))
    T = 10_027_008
    p = torch.randint(-2**31, 2**31 - 1, (T,), dtype=torch.int32,
                      device="cuda")
    mask = torch.rand(128, T, device="cuda") < 0.5
    want = {(B, mm): K.fused_metrics_plain(mask[:B], p, mm)
            for B in (1, 128) for mm in (False, True)}
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    from torch.profiler import ProfilerActivity, profile
    for name, sub, so, regs in built:
        lib = ctypes.CDLL(str(so))
        lib.tat_fused_metrics.argtypes = [vp, vp, i, ll, i, i, i, vp, vp, vp,
                                          vp, vp, vp]
        lib.tat_fused_metrics_grid.argtypes = [ll, i]
        print(f"{name}: ptxas " + " | ".join(r.split("info    : ")[-1]
                                            for r in regs), flush=True)
        for B in (1, 128):
            for mm in (False, True):
                grid = lib.tat_fused_metrics_grid(T, int(mm))
                rows = 3 if mm else 2
                part = -(-B * grid * (20 if mm else 12) // 8)
                buf = p.new_empty(rows * B + part, dtype=torch.int64)
                m = mask[:B]

                def call():
                    base = buf.data_ptr()
                    rc = lib.tat_fused_metrics(
                        m.data_ptr(), p.data_ptr(), B, T, grid, 1, int(mm),
                        base + 8 * rows * B, base, base + 8 * B,
                        base + 16 * B, base + 20 * B,
                        torch._C._cuda_getCurrentRawStream(0))
                    assert rc == 0, rc
                call()
                torch.cuda.synchronize()
                w = want[(B, mm)]
                assert torch.equal(buf[:B], w[0]) and torch.equal(
                    buf[B:2 * B], w[1]), name
                if mm:
                    mmv = buf[2 * B:3 * B].view(torch.int32)
                    assert torch.equal(mmv[:B], w[2]) and torch.equal(
                        mmv[B:], w[3]), name
                ms = S._cuda_ms(torch, call, 20)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                by = {}
                for e in prof.events():
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        k = "fold" if "fold" in e.name else "tile"
                        by[k] = by.get(k, 0) + e.time_range.elapsed_us() / 10
                print(f"  {name:22s} B={B:<4d} minmax {int(mm)} grid {grid} "
                      f"event {ms:.4f} ms  tile {by.get('tile', 0):.1f} us  "
                      f"fold {by.get('fold', 0):.1f} us  [{card}]")


if __name__ == "__main__":
    main()
