"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

The modules are copies of the reference's (``repro/configs``), each with
the published config and a ``smoke()`` reduced config of the same family,
for all ten archs: dense, MoE, Mamba, the hybrid and the two stub-frontend
backbones (``ARCH_NAMES``).  ``PORT_ARCH_NAMES`` are the port's own, which
the reference does not have: ``jamba2-mini``.
"""

from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES

_ARCH_MODULES = {
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)

_PORT_MODULES = {
    "jamba2-mini": "repro_torch.configs.jamba2_mini",
}

PORT_ARCH_NAMES = tuple(_PORT_MODULES)


def _module(name: str):
    import importlib

    modules = {**_ARCH_MODULES, **_PORT_MODULES}
    if name not in modules:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{ARCH_NAMES + PORT_ARCH_NAMES}")
    return importlib.import_module(modules[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
    "ARCH_NAMES",
    "PORT_ARCH_NAMES",
    "get_config",
    "get_smoke_config",
]
