"""The chain kernels' plain versions (chain_blocks, chain_counts,
chain_slot_counts) held against their Pallas originals in interpret mode
under the set-type chain cases of test_torch_kernels._chain_cases: OP_SET32
(a TermSet over the keyword field ORed with one over a narrow field) and
OP_SET_WIDE (a TermSet of f64 prices, the +-0 pair among them), a Fuzzy
and a Regex query (32 and 64 run slots). The same checks as
test_torch_kernels.py's, in a file of their own so that a parallel run
splits their Pallas interpret time from the other cases'."""

import pytest

import test_torch_kernels as tk
from test_torch_kernels import dual  # noqa: F401  (the module fixture)

#: the set cases of _chain_cases
SET_CASES = range(4, 8)


@pytest.mark.parametrize("case", SET_CASES)
@pytest.mark.parametrize("B,L", [(1, 1), (4, 3), (33, 16)])
def test_set_chain_blocks_plain_matches_pallas(dual, case, B, L):  # noqa: F811
    tk.test_chain_blocks_plain_matches_pallas(dual, case, B, L)


@pytest.mark.parametrize("case", SET_CASES)
@pytest.mark.parametrize("B", [1, 4, 33])
def test_set_chain_counts_plain_matches_pallas(dual, case, B):  # noqa: F811
    tk.test_chain_counts_plain_matches_pallas(dual, case, B)


@pytest.mark.parametrize("B,ns,case", [
    (B, ns, case) for case in SET_CASES
    for B, ns in ((1, 1), (1, 5), (4, 1), (4, 5))])
def test_set_chain_slot_counts_plain_matches_pallas(dual, case, B,  # noqa: F811
                                                    ns):
    tk.test_chain_slot_counts_plain_matches_pallas(dual, case, B, ns)
