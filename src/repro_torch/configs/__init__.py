"""Config registry: one module per assigned architecture (exact published
configs) plus reduced smoke variants for CPU tests.

``get_config(name)`` → full ModelConfig; ``get_smoke_config(name)`` →
same family/structure at toy width/depth (constraints preserved: head
divisibility, unit patterns, MoE expert counts divisible by the EP axis).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.config import ModelConfig

from repro_torch.configs.qwen15_4b import CONFIG as qwen15_4b, SMOKE as qwen15_4b_smoke
from repro_torch.configs.internlm2_20b import CONFIG as internlm2_20b, SMOKE as internlm2_20b_smoke
from repro_torch.configs.phi3_mini_3p8b import CONFIG as phi3_mini, SMOKE as phi3_mini_smoke
from repro_torch.configs.gemma3_27b import CONFIG as gemma3_27b, SMOKE as gemma3_27b_smoke
from repro_torch.configs.kimi_k2_1t import CONFIG as kimi_k2, SMOKE as kimi_k2_smoke
from repro_torch.configs.olmoe_1b_7b import CONFIG as olmoe, SMOKE as olmoe_smoke
from repro_torch.configs.hubert_xlarge import CONFIG as hubert, SMOKE as hubert_smoke
from repro_torch.configs.xlstm_1p3b import CONFIG as xlstm, SMOKE as xlstm_smoke
from repro_torch.configs.qwen2_vl_7b import CONFIG as qwen2_vl, SMOKE as qwen2_vl_smoke
from repro_torch.configs.zamba2_2p7b import CONFIG as zamba2, SMOKE as zamba2_smoke

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen15_4b, internlm2_20b, phi3_mini, gemma3_27b, kimi_k2,
        olmoe, hubert, xlstm, qwen2_vl, zamba2,
    ]
}

_SMOKE: Dict[str, ModelConfig] = {
    c.name: s
    for c, s in [
        (qwen15_4b, qwen15_4b_smoke), (internlm2_20b, internlm2_20b_smoke),
        (phi3_mini, phi3_mini_smoke), (gemma3_27b, gemma3_27b_smoke),
        (kimi_k2, kimi_k2_smoke), (olmoe, olmoe_smoke),
        (hubert, hubert_smoke), (xlstm, xlstm_smoke),
        (qwen2_vl, qwen2_vl_smoke), (zamba2, zamba2_smoke),
    ]
}


def arch_names() -> List[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {arch_names()}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[get_config(name).name]
