"""The LM architectures of the reference (``repro.configs.lm_archs``).

The port keeps its own copy of their values.

  arctic-480b     [hf:Snowflake/snowflake-arctic-base]  MoE 128e top-2 +
                  dense residual (Arctic's dense-MoE hybrid)
  dbrx-132b       [hf:databricks/dbrx-base]             MoE 16e top-4
  starcoder2-7b   [arXiv:2402.19173]  dense GQA kv=4, GELU
  phi3-medium-14b [arXiv:2404.14219]  dense GQA kv=10, SwiGLU
  chatglm3-6b     [arXiv:2406.12793]  dense GQA kv=2, 2D-RoPE (rotary on
                  half the head dims)

On a mesh arctic's 56 heads (and starcoder2's 36, phi3's 40) are padded
with zero heads to a count the tensor-parallel axis divides
(``head_pad_to``) and sliced off before ``wo``, their weights replicated
over heads (``head_tp=False``), as the reference's are; on one card
nothing is padded.  ``param_dtype`` is the dtype of the training masters
(``init_master_params``); serving weights take the ``dtype`` argument of
``init_params``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.families import lm_bundle, lm_shapes, lm_smoke
from repro_torch.models.transformer import TransformerConfig

# the q-block scan bounds the prefill's score transient
_BLOCK_Q = 512

LM_CONFIGS = {
    "arctic-480b": TransformerConfig(
        name="arctic-480b", n_layers=35, d_model=7168, n_heads=56,
        n_kv_heads=8, d_ff=4864, vocab_size=32000, d_head=128,
        moe_experts=128, moe_top_k=2, moe_dense_residual=True,
        param_dtype=torch.bfloat16, attn_block_q=_BLOCK_Q,
        head_tp=False, head_pad_to=64),   # 56 heads: activation-pad to 64
    "dbrx-132b": TransformerConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab_size=100352, d_head=128,
        moe_experts=16, moe_top_k=4, param_dtype=torch.bfloat16,
        attn_block_q=_BLOCK_Q),
    "starcoder2-7b": TransformerConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
        n_kv_heads=4, d_ff=18432, vocab_size=49152, d_head=128,
        gated_mlp=False, attn_block_q=_BLOCK_Q,
        head_tp=False, head_pad_to=48),   # 36 heads: activation-pad to 48
    "phi3-medium-14b": TransformerConfig(
        name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=10, d_ff=17920, vocab_size=100352, d_head=128,
        attn_block_q=_BLOCK_Q,
        head_tp=False, head_pad_to=48),   # 40 heads: activation-pad to 48
    "chatglm3-6b": TransformerConfig(
        name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
        n_kv_heads=2, d_ff=13696, vocab_size=65024, d_head=128,
        rope_fraction=0.5, attn_block_q=_BLOCK_Q),
}

for _name, _cfg in LM_CONFIGS.items():
    ArchSpec(
        name=_name, family="lm", source="assigned LM pool",
        shapes=lm_shapes(),
        make_bundle=functools.partial(lm_bundle, _cfg),
        make_smoke=functools.partial(lm_smoke, _cfg),
        config=_cfg,
    ).register()
