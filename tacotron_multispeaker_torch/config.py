"""Hyperparameter configuration for the PyTorch port.

A copy of ``tacotron_multispeaker_tpu/config.py`` (the same dataclasses,
fields, defaults and presets), kept in the port so that it imports nothing
of the JAX package.  The port adds what the JAX package lacks: Tacotron 2
(``ModelConfig.architecture`` and the fields after ``compute_dtype``) and
its presets ``tacotron2_sv2tts`` and ``tacotron2_tiny``.  Field meanings
are documented there; the notes here say only how the port reads them.

Kernel switches.  A port kernel runs exactly when its inputs lie on a
CUDA device, and its plain PyTorch version exactly when they lie on the
CPU.  Which kernels a path reaches follows two of ``ParallelConfig``'s
switches, as in the JAX package:

* ``use_pallas`` routes both CBHG conv banks through the conv-bank kernel
  (inference only), the per-step decode's attention through the
  attention-step kernel, and Griffin-Lim through the full-frame layout with
  the fused fast-iteration kernel (``dft_bf16``, ``dft_mix``) or the
  overlap-add kernel (``dft_f32``, ``dft_hi``);
* ``use_pallas_decode`` (with Bahdanau attention and a two-layer prenet)
  selects the fused decoder loop; otherwise ``generate`` runs the per-step
  decode.  The TPU's ``% 128`` gates do not carry over.

``use_pallas_seq_attention`` is read too: in the sequence-sharded decode
(``Synthesizer.make_sharded_synth`` with the encoder length over the model
axis) it runs each shard's attention step in the attention-partial kernel;
off, the shards take its plain version.  The other two switches
(``use_pallas_gru``, ``use_pallas_teacher``) are kept so that a config
round-trips between the two packages; the port does not read them: the
BiGRU scans and the teacher decoder always run in their kernels.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, replace
from typing import Any, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """STFT / mel analysis and Griffin-Lim parameters."""

    num_mels: int = 80
    num_freq: int = 1025          # rfft bins = n_fft // 2 + 1
    sample_rate: int = 20000
    frame_length_ms: float = 50.0
    frame_shift_ms: float = 12.5
    preemphasis: float = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    griffin_lim_iters: int = 15
    power: float = 1.5            # magnitude sharpening before Griffin-Lim
    # "<algo>_<prec>": the port implements algo "dft" with prec f32 | hi |
    # bf16 | mix (bf16 iterations + 3 polish iterations)
    gl_method: str = "dft_mix"
    gl_momentum: float = 0.99     # fast Griffin-Lim; 0.0 = plain GL
    silence_threshold_db: float = -40.0
    min_silence_sec: float = 0.8

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2

    @property
    def hop_length(self) -> int:
        return int(self.frame_shift_ms / 1000.0 * self.sample_rate)

    @property
    def win_length(self) -> int:
        # clamped to n_fft (an n_fft-point FFT cannot use a longer window)
        return min(int(self.frame_length_ms / 1000.0 * self.sample_rate),
                   self.n_fft)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture parameters: Tacotron-1's, and below them the fields that
    only Tacotron 2 (``architecture="tacotron2"``, models/tacotron2.py)
    reads.  Tacotron 2 also reads ``embed_depth``, ``prenet_depths``, the
    attention fields, ``outputs_per_step``, ``max_iters``, ``num_speakers``,
    ``speaker_embed_depth``, ``speaker_condition`` (``"encoder_output"``),
    ``prenet_dropout``, ``zoneout`` and ``compute_dtype``."""

    # the model Synthesizer builds (models.create_model): "tacotron" | "tacotron2"
    architecture: str = "tacotron"
    embed_depth: int = 256
    prenet_depths: Tuple[int, ...] = (256, 128)
    encoder_depth: int = 256               # CBHG proj / GRU size (128 per dir)
    encoder_bank_k: int = 16
    encoder_bank_channels: int = 128
    encoder_proj_channels: Tuple[int, ...] = (128, 128)
    encoder_highway_layers: int = 4
    attention_depth: int = 256
    attention_type: str = "bahdanau"       # "bahdanau" | "location"
    attention_location_filters: int = 32
    attention_location_kernel: int = 31
    decoder_depth: int = 256
    decoder_layers: int = 2                # residual GRU stack
    outputs_per_step: int = 5              # reduction factor r
    max_iters: int = 200                   # decoder steps at inference
    postnet_bank_k: int = 8
    postnet_bank_channels: int = 128
    postnet_proj_channels: Tuple[int, ...] = (256, 80)
    postnet_highway_layers: int = 4
    postnet_depth: int = 256
    postnet_gru_units: int = 128
    # > 0: B=1 serving scales the decoder iteration count with the text
    # length (Synthesizer._iters_for); 0 keeps the fixed max_iters
    serve_frames_per_char: float = 0.0
    num_speakers: int = 1
    speaker_embed_depth: int = 64
    speaker_condition: Tuple[str, ...] = (
        "encoder_prenet", "memory", "decoder_init")
    # prenet dropout is ALWAYS on, at inference too
    prenet_dropout: float = 0.5
    zoneout: float = 0.0
    compute_dtype: str = "bfloat16"        # "bfloat16" | "float32"
    # Tacotron 2 (Shen et al., arXiv:1712.05884 §2.2-2.3; NVIDIA/tacotron2)
    encoder_conv_layers: int = 3
    encoder_conv_channels: int = 512
    encoder_conv_width: int = 5
    encoder_lstm_units: int = 256          # per direction
    decoder_lstm_units: int = 1024         # the attention LSTM and the decoder LSTM
    postnet_conv_layers: int = 5
    postnet_conv_channels: int = 512
    postnet_conv_width: int = 5
    stop_threshold: float = 0.5            # a row stops at the first sigmoid(stop) above it


@dataclass(frozen=True)
class TrainConfig:
    """Optimization and data parameters (the port's serving path reads only
    the input buckets)."""

    batch_size: int = 32
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-6
    initial_learning_rate: float = 0.002
    warmup_steps: int = 4000
    decay_learning_rate: bool = True
    grad_clip_norm: float = 1.0
    prioritize_freq_hz: float = 3000.0
    linear_loss_low_weight: float = 1.0
    linear_loss_high_weight: float = 0.5
    loss_masking: bool = True
    fused_linear_loss: bool = True
    adam_mu_dtype: str = "float32"
    checkpoint_interval: int = 1000
    summary_interval: int = 100
    max_steps: int = 1_000_000
    batches_per_group: int = 32
    max_input_length: int = 192
    max_output_length: int = 1000
    bucket_boundaries: Tuple[int, ...] = (250, 500, 750, 1000)
    input_bucket_boundaries: Tuple[int, ...] = (96, 192)
    cmudict_prob: float = 0.02
    targets_dtype: str = "float32"
    targets_from_wav: bool = False
    wav_dft_precision: str = "highest"
    seed: int = 0


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh / sharding layout (kept for config parity; see module doc)."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1
    shard_speaker_table_min: int = 512
    use_pallas: bool = False
    use_pallas_gru: bool = True
    use_pallas_decode: bool = True
    use_pallas_teacher: bool = True
    hybrid_model_axis: bool = True
    use_pallas_seq_attention: bool = True
    bn_cross_replica: bool = False


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    cleaners: str = "english_cleaners"
    name: str = "tacotron"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def debug_string(self) -> str:
        d = dataclasses.asdict(self)
        lines = ["Hyperparameters:"]
        for section, vals in sorted(d.items()):
            if isinstance(vals, dict):
                for k, v in sorted(vals.items()):
                    lines.append(f"  {section}.{k}: {v}")
            else:
                lines.append(f"  {section}: {vals}")
        return "\n".join(lines)


def _coerce(current: Any, raw: str) -> Any:
    """Parse a CLI string into the type of the current value."""
    if isinstance(current, bool):
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        parts = [p for p in raw.strip("()[] ").split(",") if p.strip()]
        elem = current[0] if current else 0
        return tuple(type(elem)(p.strip()) for p in parts)
    return raw


def parse_overrides(cfg: Config, overrides: str | None) -> Config:
    """Apply ``section.key=value,section.key=value`` overrides; un-dotted
    keys are searched across sections for a unique match."""
    if not overrides:
        return cfg
    # split on commas not inside (...) / [...] so tuple values survive
    pairs, depth, cur = [], 0, []
    for ch in overrides:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            pairs.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    pairs.append("".join(cur))
    for pair in pairs:
        pair = pair.strip()
        if not pair:
            continue
        key, _, raw = pair.partition("=")
        if not _:
            raise ValueError(f"override {pair!r} is not k=v")
        key = key.strip()
        if "." in key:
            section, _, leaf = key.partition(".")
            sub = getattr(cfg, section)
            if not hasattr(sub, leaf):
                raise KeyError(f"unknown hparam {key!r}")
            new_sub = replace(sub, **{leaf: _coerce(getattr(sub, leaf), raw)})
            cfg = replace(cfg, **{section: new_sub})
        else:
            if hasattr(cfg, key) and not dataclasses.is_dataclass(getattr(cfg, key)):
                cfg = replace(cfg, **{key: _coerce(getattr(cfg, key), raw)})
                continue
            hits = [section for section in ("audio", "model", "train", "parallel")
                    if hasattr(getattr(cfg, section), key)]
            if len(hits) != 1:
                raise KeyError(f"ambiguous or unknown hparam {key!r} (sections: {hits})")
            sub = getattr(cfg, hits[0])
            new_sub = replace(sub, **{key: _coerce(getattr(sub, key), raw)})
            cfg = replace(cfg, **{hits[0]: new_sub})
    return cfg


# ----------------------------------------------------------------------------
# Presets
# ----------------------------------------------------------------------------

def tiny() -> Config:
    """Tiny single-speaker Tacotron (r=5, CPU-runnable)."""
    return Config(
        name="tiny",
        audio=AudioConfig(num_mels=80, num_freq=513, sample_rate=22050),
        model=ModelConfig(
            embed_depth=64,
            prenet_depths=(64, 32),
            encoder_depth=64,
            encoder_bank_k=8,
            encoder_bank_channels=32,
            encoder_proj_channels=(32, 32),
            encoder_highway_layers=2,
            attention_depth=64,
            decoder_depth=64,
            outputs_per_step=5,
            max_iters=50,
            postnet_bank_k=4,
            postnet_bank_channels=32,
            postnet_proj_channels=(64, 80),
            postnet_highway_layers=2,
            postnet_depth=64,
            postnet_gru_units=32,
            compute_dtype="float32",
        ),
        train=TrainConfig(batch_size=8, max_input_length=64, max_output_length=200,
                          bucket_boundaries=(100, 200),
                          input_bucket_boundaries=(32, 64), warmup_steps=100),
    )


def single_speaker() -> Config:
    """Full single-speaker Tacotron-1 (80-mel + 1025-linear, full CBHG)."""
    return Config(name="single_speaker")


def multispeaker_vctk() -> Config:
    """Multispeaker VCTK: speaker-embedding table, conditioned prenet/decoder."""
    return Config(
        name="multispeaker_vctk",
        audio=AudioConfig(sample_rate=22050),
        model=ModelConfig(num_speakers=109, speaker_embed_depth=64),
    )


def large_multispeaker() -> Config:
    """1k+ speakers; sharded embedding table; bucketed batches."""
    return Config(
        name="large_multispeaker",
        model=ModelConfig(num_speakers=2048, speaker_embed_depth=128),
        train=TrainConfig(batch_size=64),
        parallel=ParallelConfig(model_parallel_size=4),
    )


def pod_synthesis() -> Config:
    """Pod-scale batch synthesis (data-parallel decode)."""
    return Config(
        name="pod_synthesis",
        model=ModelConfig(num_speakers=2048, speaker_embed_depth=128, max_iters=400),
        train=TrainConfig(batch_size=256),
        parallel=ParallelConfig(model_parallel_size=4),
    )


def tacotron2_sv2tts() -> Config:
    """Tacotron 2 at its published widths with SV2TTS speaker conditioning
    (Jia et al., arXiv:1806.04558 §2.2): a 109 x 256 table of unit-length
    speaker vectors concatenated to every encoder output, r = 1, 1000
    decoder steps, VCTK's speakers at 22.05 kHz."""
    return Config(
        name="tacotron2_sv2tts",
        audio=AudioConfig(sample_rate=22050),
        model=ModelConfig(
            architecture="tacotron2", embed_depth=512, prenet_depths=(256, 256),
            attention_depth=128, attention_type="location", outputs_per_step=1,
            max_iters=1000, num_speakers=109, speaker_embed_depth=256,
            speaker_condition=("encoder_output",), zoneout=0.1),
        parallel=ParallelConfig(use_pallas=True),
    )


def tacotron2_tiny() -> Config:
    """A CPU-sized Tacotron 2 with the same structure (tests)."""
    return Config(
        name="tacotron2_tiny",
        audio=AudioConfig(num_mels=80, num_freq=513, sample_rate=22050),
        model=ModelConfig(
            architecture="tacotron2", embed_depth=32, prenet_depths=(32, 32),
            attention_depth=16, attention_type="location", attention_location_filters=4,
            attention_location_kernel=7, outputs_per_step=1, max_iters=30,
            num_speakers=4, speaker_embed_depth=8, speaker_condition=("encoder_output",),
            zoneout=0.1, compute_dtype="float32", encoder_conv_channels=32,
            encoder_lstm_units=16, decoder_lstm_units=48, postnet_conv_channels=32),
        train=TrainConfig(batch_size=8, max_input_length=64,
                          input_bucket_boundaries=(32, 64)),
    )


PRESETS = {
    "tiny": tiny,
    "single_speaker": single_speaker,
    "tacotron": single_speaker,
    "multispeaker_vctk": multispeaker_vctk,
    "large_multispeaker": large_multispeaker,
    "pod_synthesis": pod_synthesis,
    "tacotron2_sv2tts": tacotron2_sv2tts,
    "tacotron2_tiny": tacotron2_tiny,
}


def get_config(name: str = "single_speaker", overrides: str | None = None) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; options: {sorted(PRESETS)}")
    return parse_overrides(PRESETS[name](), overrides)
