"""World-1 fabric DDP of tiny zamba2-2.7b against the JAX package's
``DDPEngine`` with the fp32 and onebit codecs."""
import pytest

from torch_parity import world1_ddp_matches_reference_engine
import torch_threads

torch_threads.apply()


@pytest.mark.parametrize("arch, codec, opt_kind, rtol", [
    # tiny zamba's float32 gradients agree with the reference's to about
    # 5e-4 of their scale (test_loss_and_gradients_match_jax), and adamw's
    # normalized step turns every near-zero gradient whose sign differs
    # into a whole +-lr step: in float32 its trajectory leaves any other
    # within a few steps, the reference's own too.  Momentum's step is
    # proportional to the gradient, so the engines' agreement shows; its
    # grad_norm is held to 5e-4 (the gradients' agreement), onebit to 1e-3
    pytest.param("zamba2-2.7b", "fp32", "momentum", 5e-4,
                 id="zamba2-2.7b-fp32"),
    pytest.param("zamba2-2.7b", "onebit", "momentum", 1e-3,
                 id="zamba2-2.7b-onebit"),
])
def test_world1_ddp_matches_reference_engine(arch, codec, opt_kind, rtol):
    world1_ddp_matches_reference_engine(arch, codec, opt_kind, rtol)
