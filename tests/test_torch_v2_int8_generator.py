"""The port's HiFi-GAN V2 generator in its int8 tiers against JAX
``generator_forward(use_pallas=True, int8=True, interpret=True)`` at B=1 x
16 frames (``test_torch_v2_generator.compare_tier``: every level on JAX's
input at rel-L2 <= 2e-3, end to end <= 5e-2):

- int8-static (calibrated on the mel): L0 ``fused_mrf_ct`` q8f, L1
  ``fused_mrf_phase`` q8f without prologue, L2 and L3 the bf16 phase
  kernel (C % 32 != 0);
- int8-dynamic: L0 ``fused_mrf_ct`` q8, L1 ``fused_mrf_phase`` q8 without
  prologue, L2 and L3 bf16.
"""
import pytest

from tests.test_torch_v2_generator import compare_tier


@pytest.mark.parametrize('tier', ['static', 'dynamic'])
def test_v2_int8_tier_matches_jax(tier):
    mode = 'q8f' if tier == 'static' else 'q8'
    compare_tier(tier, 16, 6, [('ct', mode), ('phase', mode), ('phase', ''),
                               ('phase', '')])
