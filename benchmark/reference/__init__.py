"""The plain float32 reference of the benchmark: the multispeaker Tacotron-1
(encoder, speaker conditioning, Bahdanau attention decoder, post-net, loss),
Griffin-Lim and the spectrogram features, in plain PyTorch with TF32 off.

It imports nothing of the port, of JAX or of the JAX package.  It takes the
weights by the port's ``state_dict`` names (the benchmark draws them and
hands the same tensors to both sides), the text ids from its own copy of the
symbol table, and random draws from a ``torch.Generator`` seeded as the
program seeds its own (the same calls in the same order give the same bits).
``q`` rounds every product's operands: the identity for float32, or a lower
precision for the control (``precision.py``).
"""
