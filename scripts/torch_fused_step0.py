"""Where a fused_metrics kernel loses its time, on c5's root masks over
`amount` (the chip_smoke phase-4 operand, 10M-doc bench index): CUDA-event
and torch.profiler device times of the kernel of the port package in the
tree at DIR as it is, on all-zero masks (every branch skipped, only the
bytes left), and of torch_fused_once.cu's variant that reads the plane
once per CTA, in turns, at B = 1 and 128. Needs one CUDA card.

    python3 scripts/torch_fused_step0.py DIR

(DIR: a tree unpacked with `git archive <commit>
tantivy_aggregations_tpu_torch`, under a gitignored directory.)
"""
import ctypes
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import tantivy_aggregations_tpu_torch as tt  # noqa: E402
from tantivy_aggregations_tpu_torch.models import flagship  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import kernels as K  # noqa: E402
from tantivy_aggregations_tpu_torch.query import compile as qc  # noqa: E402


def main():
    card = S.phase_versions(torch, K)
    S.phase_build(K)
    old = S.load_against(sys.argv[1])
    old.build()
    out = REPO / "build" / "fused_step0"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libstep0.so"
    t0 = time.time()
    res = subprocess.run([K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                          "-Xptxas", "-v", "-o", str(so),
                          str(HERE / "torch_fused_once.cu")],
                         capture_output=True, text=True)
    print("step0 nvcc", res.returncode, f"{time.time() - t0:.1f}s")
    print(res.stderr[-3000:])
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.step0_once.argtypes = [vp, vp, ctypes.c_int, ctypes.c_longlong, vp,
                               vp, vp, vp, vp]
    lib.step0_once.restype = ctypes.c_int

    idx = S.phase_index(tt, flagship)
    searcher = idx.searcher(device="cuda")
    cfgs = {name: (q, aggs) for _, name, q, aggs in S.all_configs(flagship)}
    p1 = searcher._program_for(*cfgs["c1_count_sum"])
    q5, a5 = cfgs["c5_percentiles_mixed_postfilter"]
    p5 = searcher._program_for(q5, a5)
    amount = p1._arrays["amount:w"]
    reqs = flagship.varied_requests(5, a5, 128)
    pm5 = qc.param_matrix([p5._extract(q, a) for q, a in reqs], p5._pkeys,
                          p5.device)
    mask128 = (p5._chain_mask(p5._root, pm5, p5._arrays)
               & (p5._arrays["alive"] > 0)).contiguous()
    T = amount.shape[0]
    print(f"T {T}, mask {tuple(mask128.shape)} selected "
          f"{int(mask128.sum())} [{card}]")

    def once(m):
        B = m.shape[0]
        cnt = torch.zeros(B, dtype=torch.int64, device="cuda")
        tot = torch.zeros(B, dtype=torch.int64, device="cuda")
        mn = torch.full((B,), K.I32_MAX, dtype=torch.int32, device="cuda")
        mx = torch.full((B,), K.I32_MIN, dtype=torch.int32, device="cuda")
        rc = lib.step0_once(m.data_ptr(), amount.data_ptr(), B, T,
                            cnt.data_ptr(), tot.data_ptr(), mn.data_ptr(),
                            mx.data_ptr(),
                            torch._C._cuda_getCurrentRawStream(0))
        assert rc == 0, rc
        return cnt, tot, mn, mx

    for B in (1, 128):
        m = mask128[:B].contiguous()
        zero = torch.zeros_like(m)
        for label, mm in (("c5", m), ("zero", zero)):
            want = K.fused_metrics_plain(mm, amount)
            got = old.fused_metrics(mm, amount)
            var = once(mm)
            for g, v, w in zip(got, var, want):
                assert torch.equal(g, w) and torch.equal(v, w)
            fa = lambda mm=mm: old.fused_metrics(mm, amount)  # noqa: E731
            fb = lambda mm=mm: once(mm)  # noqa: E731
            t = [S._cuda_ms(torch, f, 20) for f in (fa, fb, fb, fa)]
            da = S._device_ms(torch, fa)
            db = S._device_ms(torch, fb)
            print(f"B={B} {label}: DIR's kernel {t[0]:.4f} {t[3]:.4f} ms "
                  f"(device {da}), plane-once variant {t[1]:.4f} "
                  f"{t[2]:.4f} ms (device {db})  [{card}]")


if __name__ == "__main__":
    main()
