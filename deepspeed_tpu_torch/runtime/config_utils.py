"""Config plumbing shared by all sub-configs (a copy of
``deepspeed_tpu/runtime/config_utils.py``; the port keeps its own, with
the standard library's logger).

Each sub-config is a dataclass with a ``from_dict`` that accepts the
reference's JSON key names, warns on unknown keys, and validates types.
"""

import dataclasses
import logging

logger = logging.getLogger("deepspeed_tpu_torch")


class DeepSpeedConfigError(Exception):
    pass


def dict_to_dataclass(cls, d: dict, path: str = ""):
    """Build dataclass ``cls`` from dict ``d``; unknown keys warn, not fail."""
    if d is None:
        d = {}
    if not isinstance(d, dict):
        raise DeepSpeedConfigError(f"Config section '{path}' must be a dict, got {type(d)}")
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k in field_names:
            kwargs[k] = v
        else:
            logger.warning(f"Unknown config key '{path}.{k}' ignored")
    return cls(**kwargs)


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dataclass_to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: dataclass_to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: dataclass_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [dataclass_to_dict(v) for v in obj]
    return obj
