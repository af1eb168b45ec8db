"""Alignment plotting (reference: util/plot.py).

The alignment plot of ``tacotron_multispeaker_tpu/utils/plot.py``, the one
the train loop draws; matplotlib is imported when a plot is drawn, not with
the module.

Alignment plots are the key TTS debugging artifact: a clean diagonal means
attention has learned the text→audio monotonic map.
"""

from __future__ import annotations

import numpy as np


def plot_alignment(alignment: np.ndarray, path: str,
                   info: str | None = None) -> None:
    """alignment: [decoder_steps, encoder_steps] attention matrix."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    im = ax.imshow(np.asarray(alignment).T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep"
    if info is not None:
        xlabel += "\n\n" + info
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Encoder timestep")
    plt.tight_layout()
    plt.savefig(path, format="png")
    plt.close(fig)

