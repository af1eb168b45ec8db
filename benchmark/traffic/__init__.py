"""Seeded traffic: texts, speakers, synthesis calls and the training corpus,
from the parameters of a mix file (``mixes/<traffic>.json``)."""
