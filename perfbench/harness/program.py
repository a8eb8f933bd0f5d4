"""The program under test, as the benchmark builds it: a ModelConfig from
a configuration file's ``program`` section.  The only module of the
harness outside ``drivers/`` that imports ``repro_torch``."""
from __future__ import annotations

import dataclasses


def model_config(program: dict):
    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in program.items() if k in fields}
    return ModelConfig(**kw)
