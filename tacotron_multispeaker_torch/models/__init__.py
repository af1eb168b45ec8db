"""Model registry (port of ``tacotron_multispeaker_tpu/models/__init__.py``)."""

from .losses import priority_bins, tacotron_loss  # noqa: F401
from .tacotron import Tacotron, TacotronOutput  # noqa: F401
from .tacotron2 import Tacotron2, Tacotron2Output  # noqa: F401

# by ``model.architecture``: Tacotron-1 (the JAX package's) and Tacotron 2
_MODELS = {"tacotron": Tacotron, "tacotron2": Tacotron2}


def create_model(name: str, cfg, seq_mesh=None, bn_group=None):
    """The model ``name`` for ``cfg``, on the CPU, with uninitialised weights
    (``reset_parameters`` draws them, or load a state dict).
    ``seq_mesh``: the sequence-sharded decode over the mesh's model axis.
    ``bn_group``: a process group over which the BatchNorms take their
    training statistics (the JAX ``bn_axis``)."""
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; options: {sorted(_MODELS)}")
    return _MODELS[name](cfg, seq_mesh=seq_mesh, bn_group=bn_group)
