"""The dense LM architectures of the reference (``repro.configs.lm_archs``).

The port keeps its own copy of their values; the MoE ones (arctic-480b,
dbrx-132b) are not ported.

  starcoder2-7b   [arXiv:2402.19173]  dense GQA kv=4, GELU
  phi3-medium-14b [arXiv:2404.14219]  dense GQA kv=10, SwiGLU
  chatglm3-6b     [arXiv:2406.12793]  dense GQA kv=2, 2D-RoPE (rotary on
                  half the head dims)
"""
from __future__ import annotations

from repro_torch.models.transformer import TransformerConfig

# the q-block scan bounds the prefill's score transient
_BLOCK_Q = 512

LM_CONFIGS = {
    "starcoder2-7b": TransformerConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
        n_kv_heads=4, d_ff=18432, vocab_size=49152, d_head=128,
        gated_mlp=False, attn_block_q=_BLOCK_Q),
    "phi3-medium-14b": TransformerConfig(
        name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=10, d_ff=17920, vocab_size=100352, d_head=128,
        attn_block_q=_BLOCK_Q),
    "chatglm3-6b": TransformerConfig(
        name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
        n_kv_heads=2, d_ff=13696, vocab_size=65024, d_head=128,
        rope_fraction=0.5, attn_block_q=_BLOCK_Q),
}
