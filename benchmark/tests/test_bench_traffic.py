"""The seeded generators."""

import itertools

import numpy as np

from benchmark import core
from benchmark.reference.text import encode
from benchmark.traffic import generate

SYNTH = core.load_json(core.HERE / "traffic/mixes/synth_b32.json")
TRAIN = core.load_json(core.HERE / "traffic/mixes/train_b32.json")
BIG = 2**31 + 12345


def calls(seed, n=40, mix=SYNTH, speakers=109):
    return list(itertools.islice(generate.synth_calls(mix, speakers, seed), n))


def test_synth_calls_deterministic_and_in_range():
    a, b = calls(BIG), calls(BIG)
    assert [(c.texts, c.speaker_ids, c.seed, c.bucket) for c in a] == \
        [(c.texts, c.speaker_ids, c.seed, c.bucket) for c in b]
    for c in a:
        assert len(c.texts) == SYNTH["batch"]
        lengths = [len(t) for t in c.texts]
        assert min(lengths) >= SYNTH["min_chars"] and max(lengths) <= SYNTH["max_chars"]
        assert max(len(encode(t)) for t in c.texts) <= c.bucket
        assert c.bucket == min(b for b in SYNTH["buckets"] if max(lengths) + 1 <= b)
        assert all(0 <= s < 109 for s in c.speaker_ids)


def test_synth_calls_same_sizes_any_seed():
    sizes = lambda seed: sorted((c.bucket, tuple(sorted(len(t) for t in c.texts)))
                                for c in calls(seed, 19))
    assert sizes(BIG) == sizes(7) and calls(BIG)[0].texts != calls(7)[0].texts


def test_corpus_deterministic_distinct_and_in_range():
    rows = generate.corpus(TRAIN, 109, BIG)
    assert rows == generate.corpus(TRAIN, 109, BIG)
    assert len(rows) == TRAIN["utterances"] == len({t for t, _ in rows})
    lengths = [len(t) for t, _ in rows]
    assert min(lengths) >= TRAIN["min_chars"] and max(lengths) <= TRAIN["max_chars"]
    assert abs(np.median(lengths) - TRAIN["median_chars"]) <= 3
    assert sorted(lengths) == sorted(len(t) for t, _ in generate.corpus(TRAIN, 109, 5))
    assert all(0 <= s < 109 for _, s in rows)


def test_utterance_duration():
    wav = generate.synth_utterance("ab c.", 3, 22050, 0.06)
    assert len(wav) == 5 * int(0.06 * 22050) and wav.dtype == np.float32
    assert np.abs(wav).max() <= 0.8 + 1e-6
