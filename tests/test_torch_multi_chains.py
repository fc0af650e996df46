"""The chain kernels' plain versions (chain_blocks, chain_counts,
chain_slot_counts) held against their Pallas originals in interpret mode
under the multi-valued chain cases of test_torch_kernels._chain_cases:
leaves over a narrow and a keyword multi-valued field (an OR over their
per-position planes mp{k}, a range guarded against the -1 fill by
OP_GT_IMM), over a wide one (mph{k}, mpl{k} pairs guarded by the value
count mpn), and Exists on every field kind. The same checks as
test_torch_kernels.py's, in a file of their own so that a parallel run
splits their Pallas interpret time from the other cases'."""

import pytest

import test_torch_kernels as tk
from test_torch_kernels import dual  # noqa: F401  (the module fixture)
from tantivy_aggregations_tpu_torch.query import compile as pqc

#: the multi-valued cases of _chain_cases
MULTI_CASES = range(8, 11)


def test_multi_cases_emit_the_plane_guard(dual):  # noqa: F811
    jd, pd = dual
    for case in MULTI_CASES:
        build = tk._chain_cases(tk.tt, jd)[case]
        mp = pqc.mask_program(((build(0), ("q",)),), pd)
        assert pqc.OP_GT_IMM in mp.ops[:, 0] and mp.dense, case
        assert any(":mp" in k for k in mp.plane_keys), case


@pytest.mark.parametrize("case", MULTI_CASES)
@pytest.mark.parametrize("B,L", [(1, 1), (4, 3)])
def test_multi_chain_blocks_plain_matches_pallas(dual, case, B,  # noqa: F811
                                                 L):
    tk.test_chain_blocks_plain_matches_pallas(dual, case, B, L)


@pytest.mark.parametrize("case", MULTI_CASES)
@pytest.mark.parametrize("B", [1, 4])
def test_multi_chain_counts_plain_matches_pallas(dual, case,  # noqa: F811
                                                 B):
    tk.test_chain_counts_plain_matches_pallas(dual, case, B)


@pytest.mark.parametrize("B,ns,case", [
    (B, ns, case) for case in MULTI_CASES for B, ns in ((1, 5), (4, 1))])
def test_multi_chain_slot_counts_plain_matches_pallas(dual, case, B,  # noqa
                                                      ns):
    tk.test_chain_slot_counts_plain_matches_pallas(dual, case, B, ns)
