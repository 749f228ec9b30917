"""Which JAX-package tests Tier-1 (`pytest tests/ -m 'not slow'`) leaves out.

`TIER1_SLOW` names the JAX package's tests that take over 20 s each when run
alone on a cold compile cache (up to over 1,500 s); this file marks them
`slow`, so they run under `-m slow`. Tier-1's command passes its own `-m`,
which replaces the `-m 'not slow and not mid'` of `pyproject.toml`'s
`addopts`, so it takes in the `mid` files and `tests/test_golden.py` too.
The selection lives here, and not as marks in those test files, because the
JAX package's test files and `tests/conftest.py` are not edited.
`tests/test_tier1_list.py` checks that every entry still names a test.
"""

import pytest

TIER1_SLOW = frozenset({
    "tests/test_device_prover.py::test_device_zk_phase_matches_host[quad-2-2]",
    "tests/test_device_prover.py::test_device_zk_phase_matches_host[cubic-4-3]",
    "tests/test_device_prover.py::test_device_prover_nizk_end_to_end",
    "tests/test_device_prover.py::test_device_product_layers_match_host",
    "tests/test_device_prover.py::test_device_dotproduct_log_matches_host",
    "tests/test_sharded_prover.py::test_nizk_proof_bytes_sharded_equal",
    "tests/test_sharded_prover.py::test_sharded_rounds_match_reference_kernels",
    "tests/test_sharded_prover.py::test_msm_rows_blocked_matches",
    "tests/test_sharded_prover.py::test_sharded_product_layer_matches",
    "tests/test_sharded_prover.py::test_snark_proof_bytes_sharded_equal",
    "tests/test_pallas.py::test_fold_evals_cubic_matches_xla[8]",
    "tests/test_pallas.py::test_fold_evals_cubic_matches_xla[64]",
    "tests/test_pallas.py::test_fold_evals_cubic_matches_xla[4096]",
    "tests/test_pallas.py::test_fold_evals_quad_matches_xla[8]",
    "tests/test_pallas.py::test_fold_evals_quad_matches_xla[256]",
    "tests/test_pallas.py::test_pair_state_round_trip",
    "tests/test_golden.py::test_golden[instance_digest.bin]",
    "tests/test_golden.py::test_golden[nizk_proof.bin]",
    "tests/test_golden.py::test_golden[snark_commitment.bin]",
    "tests/test_golden.py::test_golden[snark_proof.bin]",
    "tests/test_golden.py::test_golden[fs_challenge.bin]",
    "tests/test_curve.py::test_msm_naive_vs_host",
    "tests/test_curve.py::test_msm_pippenger_vs_host",
    "tests/test_curve.py::test_msm_adversarial_digit_patterns",
    "tests/test_curve.py::test_msm_rows_vs_per_row",
    "tests/test_curve.py::test_msm_chunked_equality",
    "tests/test_dcn.py::test_msm_two_tier_vs_host",
    "tests/test_nizk.py::test_stable_rounds_byte_parity",
    "tests/test_nizk.py::test_stable_rounds_tiered_byte_parity",
    "tests/test_nizk.py::test_r1cs_proof_roundtrip",
    "tests/test_nizk.py::test_nizk_end_to_end_and_tamper",
    "tests/test_nizk.py::test_padded_constraints_nizk",
    "tests/test_protocols.py::test_nonzk_sumcheck_cubic",
    "tests/test_protocols.py::test_poly_commit_eval_roundtrip",
    "tests/test_serialize.py::test_nizk_roundtrip",
    "tests/test_serialize.py::test_snark_roundtrip",
    "tests/test_serialize.py::test_malformed_proof_fuzz",
    "tests/test_snark.py::test_batched_product_proof_roundtrip",
    "tests/test_snark.py::test_sparse_polyeval_proof",
    "tests/test_snark.py::test_snark_end_to_end",
    "tests/test_snark.py::test_padded_constraints_snark",
    "tests/test_snark.py::test_snark_stable_rounds_byte_parity",
    "tests/test_snark.py::test_snark_stable_rounds_tiered_byte_parity",
})


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: the marks must be on before `-m` deselects.
    for item in items:
        if item.nodeid in TIER1_SLOW:
            item.add_marker(pytest.mark.slow)
