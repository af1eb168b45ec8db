"""Model registry (port of ``tacotron_multispeaker_tpu/models/__init__.py``)."""

from .losses import priority_bins, tacotron_loss  # noqa: F401
from .tacotron import Tacotron, TacotronOutput  # noqa: F401

_MODELS = {"tacotron": Tacotron}


def create_model(name: str, cfg) -> Tacotron:
    """The model ``name`` for ``cfg``, on the CPU, with uninitialised weights
    (``Tacotron.reset_parameters`` draws them, or load a state dict)."""
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; options: {sorted(_MODELS)}")
    return _MODELS[name](cfg)
