"""The LM architectures of the reference (``repro.configs.lm_archs``).

The port keeps its own copy of their values.

  arctic-480b     [hf:Snowflake/snowflake-arctic-base]  MoE 128e top-2 +
                  dense residual (Arctic's dense-MoE hybrid)
  dbrx-132b       [hf:databricks/dbrx-base]             MoE 16e top-4
  starcoder2-7b   [arXiv:2402.19173]  dense GQA kv=4, GELU
  phi3-medium-14b [arXiv:2404.14219]  dense GQA kv=10, SwiGLU
  chatglm3-6b     [arXiv:2406.12793]  dense GQA kv=2, 2D-RoPE (rotary on
                  half the head dims)

Left out, as sharding only: ``head_tp``, ``head_pad_to`` and the mesh
placement of ``moe_dp_groups``.  The reference pads arctic's 56 heads (and
starcoder2's 36, phi3's 40) with zero heads to a count its tensor-parallel
mesh divides and slices them off before ``wo``, so the result is the same
without them; one card has no mesh to pad for.  ``param_dtype`` is the
dtype of the training masters (``init_master_params``); serving weights
take the ``dtype`` argument of ``init_params``.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import TransformerConfig

# the q-block scan bounds the prefill's score transient
_BLOCK_Q = 512

LM_CONFIGS = {
    "arctic-480b": TransformerConfig(
        name="arctic-480b", n_layers=35, d_model=7168, n_heads=56,
        n_kv_heads=8, d_ff=4864, vocab_size=32000, d_head=128,
        moe_experts=128, moe_top_k=2, moe_dense_residual=True,
        param_dtype=torch.bfloat16, attn_block_q=_BLOCK_Q),
    "dbrx-132b": TransformerConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab_size=100352, d_head=128,
        moe_experts=16, moe_top_k=4, param_dtype=torch.bfloat16,
        attn_block_q=_BLOCK_Q),
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
