"""The port's HiFi-GAN V2 generator at 12 frames against JAX
``generator_forward(use_pallas=True, interpret=True)``, each tier
(``test_torch_v2_generator.compare_tier``). No phase tile divides L1's
768 or L2's 1536 samples (p*128 does not), so both fall back to
``fused_mrf_ct``: per-tap q8f / q8 at C = 32 in the int8 tiers, merged-tap
bf16 at C = 32 (bf16 tier) and C = 16; L3's 3072 samples take the phase
kernel at its smallest tile (128 columns).
"""
import pytest

from tests.test_torch_v2_generator import compare_tier


@pytest.mark.parametrize('tier', ['bf16', 'static', 'dynamic'])
def test_v2_ct_fallback_matches_jax(tier):
    mode = {'bf16': '', 'static': 'q8f', 'dynamic': 'q8'}[tier]
    compare_tier(tier, 12, 8, [('ct', mode), ('ct', mode), ('ct', ''),
                               ('phase', '')])
