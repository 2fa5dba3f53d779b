"""Distributed VB-EM over a device mesh.

Reference parity: the reference's only scale-out is Kaldi-style
file-based map-reduce over SGE job arrays (``recipes/*/utils/parallel``,
SURVEY.md §2.10): shard the utterance list, accumulate statistics per
job, sum the statistics files, apply one conjugate update.  The on-device
equivalent is *mathematically identical*: ``shard_map`` over a
1-D ``data`` mesh axis, one ``psum`` of the statistics pytree over the
device interconnect per step.  Because VB-EM synchronizes once per (mini)batch on O(K·D²)
statistics (not O(model)), communication is trivially cheap.

Exposed as a first-class module so single-host and multi-host recipes
stay identical (SURVEY §5.8).
"""

from beer_tpu.parallel.data_parallel import (
    data_parallel_elbo_and_stats,
    make_mesh,
    make_supervised_vb_train_step,
    make_vb_estep,
    make_vb_minibatch_step,
    make_vb_train_step,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "make_vb_train_step",
    "make_vb_minibatch_step",
    "make_vb_estep",
    "make_supervised_vb_train_step",
    "data_parallel_elbo_and_stats",
    "shard_batch",
]
