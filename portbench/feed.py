"""Inputs from the seed: the record store a cell's batches come from, the
order of its batches, and each step's CPU generator.

The records are the port's own input path at set-up: seeded synthetic
source clips (`data.synthetic.make_source_clips`), windowed and filtered by
`data.preprocessor.DataPreprocessor` into a record store in a temporary
directory, read by `data.dataset.SpeechMotionDataset`. Sub-seeds are drawn
from the run's seed with numpy's SeedSequence, one stream per use.
"""

from __future__ import annotations

import numpy as np
import torch

# streams of the run's seed
WEIGHTS, CLIPS, ORDER, STEPS, SAMPLES = range(1, 6)


def sub_seed(seed: int, stream: int, *more: int) -> int:
    """A 63-bit seed of `stream` (and `more`) of the run seeded `seed`."""
    state = np.random.SeedSequence([seed, stream, *more]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def step_rng(seed: int, k: int) -> torch.Generator:
    """The CPU generator that step (or call) `k` of the run draws from."""
    return torch.Generator().manual_seed(sub_seed(seed, STEPS, k))


def write_records(cfg, clips: int, clip_seconds: float, seed: int, path: str) -> int:
    """Seeded source clips, one a speaker, through the port's preprocessor
    into the record store at `path`; returns the windows written."""
    from hop_tpu_torch.data import synthetic
    from hop_tpu_torch.data.preprocessor import DataPreprocessor
    videos = synthetic.make_source_clips(cfg, n_videos=clips, clip_seconds=clip_seconds,
                                         seed=sub_seed(seed, CLIPS))
    return DataPreprocessor(cfg.data, path).run(videos)


def open_dataset(cfg, path: str):
    """The port's dataset over the records, its vocabulary built from the
    records' words as the training entry builds it."""
    from hop_tpu_torch.data.dataset import SpeechMotionDataset
    from hop_tpu_torch.data.vocab import build_vocab
    ds = SpeechMotionDataset(path, cfg.data)
    ds.set_lang_model(build_vocab("words", [[w for aux in ds._aux_cache for w in aux["words"]]],
                                  None, None, cfg.data.wordembed_dim))
    return ds


def epoch_batches(seed: int, n_records: int, batch: int):
    """Index arrays of the batches in order: each epoch a seeded permutation
    of the records cut into whole batches."""
    epoch = 0
    while True:
        order = np.random.default_rng(sub_seed(seed, ORDER, epoch)).permutation(n_records)
        for i in range(n_records // batch):
            yield order[i * batch:(i + 1) * batch]
        epoch += 1


def drawn_batches(seed: int, n_records: int, batch: int, count: int) -> list:
    """`count` index arrays of `batch` records drawn with replacement."""
    rng = np.random.default_rng(sub_seed(seed, ORDER))
    return [rng.integers(0, n_records, size=batch) for _ in range(count)]
