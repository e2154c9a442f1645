"""Gradient accumulation in the port's data-parallel step at 2 gloo ranks
on the CPU: `cap%tv` with accumulation 2 over two global batches (the
first with unequal valid-token counts on the two ranks), as plain data
parallelism and as ZeRO-1, against JAX's single-device `make_train_step`
under `optax.MultiSteps` on the same global batches, draws injected. The
inner call runs no collective and updates nothing; the second averages
the window over the calls and the ranks. Set-up and tolerances are
`tests/test_torch_data_parallel.py`'s.
"""

import numpy as np
import pytest

from test_torch_data_parallel import (_batch, check_losses, check_params,
                                      check_split, run_cases)

CASES = [("cap_accum2_dp", "cap%tv", False, 2, "cap_accum2"),
         ("cap_accum2_zero1", "cap%tv", True, 2, "cap_accum2")]


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    rng = np.random.default_rng(11)
    return run_cases(tmp_path_factory, CASES, {
        "cap_accum2": ("cap%tv", 2, [(_batch(rng, True), 0),
                                     (_batch(rng, False), 1)])})


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_accumulated_losses_match_jax(stepped, case):
    check_losses(stepped, case, CASES)
    # the window's first call reports its losses and no update
    assert all("grad_norm" not in o["losses"][0] and "grad_norm" in
               o["losses"][1] for o in stepped[3][case])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_accumulated_params_match_jax(stepped, case):
    check_params(stepped, case, CASES)


def test_accumulated_zero1_splits_the_moments(stepped):
    check_split(stepped, "cap_accum2_zero1", plain="cap_accum2_dp")
