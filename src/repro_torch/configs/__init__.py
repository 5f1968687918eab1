"""Architecture registry: one module per assigned architecture.

``get_config(arch)`` returns the exact published config; ``get_smoke(arch)``
returns a reduced same-family config for CPU smoke tests.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "mixtral_8x22b",
    "deepseek_v2_236b",
    "llama3_405b",
    "yi_9b",
    "yi_6b",
    "qwen1_5_0_5b",
    "recurrentgemma_9b",
    "whisper_small",
    "mamba2_130m",
    "internvl2_26b",
)

# accept dashed public ids too (--arch mixtral-8x22b)
def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch)}")
    return mod.config()


def get_smoke(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch)}")
    return mod.smoke()


def all_archs():
    return ARCHS
