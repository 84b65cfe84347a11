"""World-1 fabric DDP of tiny qwen3-4b against the JAX package's
``DDPEngine`` with the fp32 and onebit codecs (the zamba cases are
``tests/test_torch_train_ddp_zamba.py``: a file each, so that the
suite's workers take them apart)."""
import pytest

from torch_parity import world1_ddp_matches_reference_engine
import torch_threads

torch_threads.apply()


@pytest.mark.parametrize("arch, codec, opt_kind, rtol", [
    pytest.param("qwen3-4b", "fp32", "adamw", 1e-4, id="fp32-0.0001"),
    # a sign whose q lies near 0 may flip between the two sides, which
    # moves that element by a whole +-scale: held to 1e-3
    pytest.param("qwen3-4b", "onebit", "adamw", 1e-3, id="onebit-0.001"),
])
def test_world1_ddp_matches_reference_engine(arch, codec, opt_kind, rtol):
    world1_ddp_matches_reference_engine(arch, codec, opt_kind, rtol)
