"""A quick check of fused_metrics on the card without the bench index:
build (ptxas report), == the plain version on synthetic operands (T below
and past a tile, a tail, B 1-200, int8 masks, INT32_MIN / INT32_MAX
planes under full masks, stride-0 masks; minmax off and on), then CUDA
event and profiler device times at B = 1 and 128 on random masks over
10,027,008 rows, per kernel (tile kernel and fold), and on a shared mask.
Needs one CUDA card.

    python3 scripts/torch_fused_check.py
"""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from tantivy_aggregations_tpu_torch.ops import kernels as K  # noqa: E402

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def main():
    card = S.phase_versions(torch, K)
    S.phase_build(K)
    rng = np.random.default_rng(7)
    cases = []
    for T in (1000, 2048, 12308, 32768, 100_000):
        for B in (1, 2, 3, 5, 8, 31, 33, 200):
            plane = rng.integers(I32_MIN, I32_MAX, T, endpoint=True)
            m = rng.choice(np.array([0, 0, 0, 1, -1, 2, 127, -128], np.int8),
                           (B, T))
            m[0, :] = 0
            cases.append((f"T={T} B={B}", torch.from_numpy(m).cuda(),
                          torch.from_numpy(plane.astype(np.int32)).cuda()))
    T = 10_027_008
    for v in (I32_MIN, I32_MAX):
        cases.append((f"extreme {v}", torch.ones(2, T, dtype=torch.bool,
                                                  device="cuda"),
                      torch.full((T,), v, dtype=torch.int32, device="cuda")))
    p = torch.randint(0, 1 << 20, (T,), dtype=torch.int32, device="cuda")
    row = torch.rand(T, device="cuda") < 0.5
    cases.append(("shared B=128", row[None].expand(128, T), p))
    cases.append(("shared B=33 uint8", row.to(torch.uint8)[None].expand(33, T),
                  p))
    for label, m, pl in cases:
        for mm in (False, True):
            got = K.fused_metrics(m, pl, minmax=mm)
            want = K.fused_metrics_plain(m, pl, mm)
            for g, w in zip(got, want):
                assert (g is None) == (w is None), label
                if g is not None:
                    assert g.shape == w.shape and g.dtype == w.dtype, label
                    assert torch.equal(g, w), (label, mm, g[:4], w[:4])
        print("ok", label)
    mask = torch.rand(128, T, device="cuda") < 0.5
    for B in (1, 128):
        for mm in (False, True):
            f = lambda B=B, mm=mm: K.fused_metrics(  # noqa: E731
                mask[:B], p, minmax=mm)
            print(f"B={B} minmax={mm}: {S._cuda_ms(torch, f, 20):.4f} ms, "
                  f"device {S._device_ms(torch, f)} [{card}]")
    from torch.profiler import ProfilerActivity, profile
    for B in (1, 128):
        for mm in (False, True):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    K.fused_metrics(mask[:B], p, minmax=mm)
                torch.cuda.synchronize()
            by = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    k = e.name[:60]
                    by[k] = by.get(k, 0) + e.time_range.elapsed_us() / 10
            print(f"B={B} minmax={mm} per call us:", by)
    f = lambda: K.fused_metrics(  # noqa: E731
        row[None].expand(128, T), p, minmax=False)
    print(f"shared B=128: {S._cuda_ms(torch, f, 20):.4f} ms, device "
          f"{S._device_ms(torch, f)}")


if __name__ == "__main__":
    main()
