"""PyTorch port: a quantized base (``--bits 4`` and ``--bits 8``, the
unfused layout) with LoRA, placed over two gloo ranks at meshes (2, 1) and
(1, 2): one step against the JAX step on one device, at the tolerances
and through the worlds of ``tests/test_torch_placed_repairs.py``
(``run_worlds``), in a file of its own so that the two run side by side.
"""

import pytest

from tests.test_torch_placed_repairs import check_case, run_worlds


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory, ["int4", "int8"])


@pytest.mark.parametrize("case,shape", [("int4", (2, 1)), ("int4", (1, 2)),
                                        ("int8", (2, 1)), ("int8", (1, 2))])
def test_placed_lora_step_equals_the_jax_step(worlds, case, shape):
    check_case(worlds, case, shape)
