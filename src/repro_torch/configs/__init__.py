"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

The modules are copies of the reference's (``repro/configs``), with the
published config and a ``smoke()`` reduced config of the same family.  The
registry lists only the archs whose families the port runs: the dense
decoders.  MoE, Mamba, hybrid and frontend archs wait for ROADMAP.md queue 1
item 4; asking for one raises a ``KeyError`` that says so.
"""

from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES

_ARCH_MODULES = {
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)

# The reference's archs whose families (MoE, Mamba, hybrid, VLM, audio) the
# port does not run yet.
NOT_PORTED = ("internvl2-26b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
              "musicgen-medium", "falcon-mamba-7b", "jamba-v0.1-52b")


def _module(name: str):
    import importlib

    if name not in _ARCH_MODULES:
        if name in NOT_PORTED:
            raise KeyError(
                f"arch {name!r} is not ported yet: its family waits for "
                f"ROADMAP.md queue 1 item 4; ported: {ARCH_NAMES}")
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
    "ARCH_NAMES",
    "NOT_PORTED",
    "get_config",
    "get_smoke_config",
]
