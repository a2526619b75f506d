"""Named sharding strategies (port of ``repro/parallel/strategies.py``).

Each strategy is a complete AxisRules table; swap with --rules in
launch/dryrun.py (no model-code change, see parallel/sharding.py).

  baseline     2-D token sharding (batch x seq) + full ZeRO-3 FSDP over
               (data x model); K/V gathered over 'model' per attention.
  tp-ffn       Megatron-style: sequence replicated inside the block, FFN
               activations sharded on 'model' (d_ff), attention heads on
               'model' where divisible; weights FSDP only over 'data'.
               Trades the per-layer weight all-gather over 256 devices for
               activation all-reduces over 16.
  small-repl   baseline, but small recurrent weights (sLSTM/mLSTM inner
               maps, norms) replicated instead of sharded — kills the
               per-timestep re-gather inside sequential scans.
  seq-data     long-context: residual sequence sharded over ('data','model')
               jointly (batch=1 decode / prefill where batch < data axis).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.parallel.sharding import AxisRules, DEFAULT_RULES

STRATEGIES: Dict[str, AxisRules] = {}

STRATEGIES["baseline"] = DEFAULT_RULES

STRATEGIES["tp-ffn"] = DEFAULT_RULES.with_overrides(
    seq=None,  # sequence replicated inside blocks
    mlp_act="model",  # FFN hidden sharded (Megatron column-parallel)
    heads_act="model",  # attention heads sharded where divisible
    # weights: TP dims live on 'model' persistently; FSDP only over 'data'
    mlp="model",
    heads="model",
    embed="data",
)

STRATEGIES["small-repl"] = DEFAULT_RULES.with_overrides(
    embed2=None,  # sLSTM square maps replicated
    conv=None,
    state=None,
)

# Decode/serving: weights stay resident TP-sharded — FFN on d_ff, attention
# on head_dim (128/16 always divides, unlike head counts), unembed on vocab —
# with matching activation constraints so no weight is all-gathered:
# only KB-scale activation all-reduces move per token. KV cache stays
# (batch@data, seq@model) with partial softmax.
STRATEGIES["decode-tp"] = DEFAULT_RULES.with_overrides(
    embed=None,          # weight d_model dims replicated (activations tiny)
    mlp="model",         # FFN column-parallel
    mlp_act="model",
    head_dim="model",    # attention sliced on head_dim
    heads=None,
    vocab="model",
    embed2="model",
)

# MoE with small per-expert FFNs (granite: 50M params/layer total): keep
# expert weights replicated and dispatch block-locally — zero MoE
# collectives, top_k·cf× (not E×) activation buffers. Pair with
# the capacity dispatch.
STRATEGIES["moe-blocked"] = DEFAULT_RULES.with_overrides(
    expert=None,
    expert_act=None,
)

STRATEGIES["seq-data"] = DEFAULT_RULES.with_overrides(
    seq=("data", "model"),
    batch=None,
    dp_batch=None,
)


def get_strategy(name: str) -> AxisRules:
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; have {sorted(STRATEGIES)}")
    return STRATEGIES[name]
