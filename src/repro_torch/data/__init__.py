"""Data layer: synthetic corpus + DDF preprocessing -> training batches
(ports ``repro/data``)."""

from .pipeline import (CorpusConfig, batches_from_table, preprocess,
                       source_weights, synth_corpus)

__all__ = ["CorpusConfig", "batches_from_table", "preprocess",
           "source_weights", "synth_corpus"]
