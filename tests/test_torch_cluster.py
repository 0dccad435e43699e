"""The spec the cluster kernel is held to, on the CPU: the plain version of
`cluster_device` (what a CPU tensor runs, and what the card's kernel is
compared with) against the host clustering, bit for bit, on the edge sets
of `pigo_tpu_torch/tools/cluster_sets.py`: every threshold from -0.1 to
1.0, scale-0 entries, fractional and negative coordinates, a valid mask
with holes and a count below the populated rows, the bit-word edges up to
4096 entries, identical entries, equal q, and the pairs at the threshold.
The card runs the same sets (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from pigo_tpu_torch import FaceCascade
from pigo_tpu_torch.ops import cluster_device as cd
from pigo_tpu_torch.ops.cluster import cluster_detections
from pigo_tpu_torch.tools import cluster_sets
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

CAP = FaceCascade.HIT_CAPACITY
SETS = {s.name: s for s in (cluster_sets.edge_sets(CAP)
                            + cluster_sets.random_sets(CAP))}


def host_clusters(cs):
    with np.errstate(invalid="ignore"):  # 0 / 0 for two scale-0 entries
        return cluster_detections(cs.entries(), cs.iou).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SETS))
def test_plain_equals_host_clustering(name):
    """The valid slots, compacted, are the host's clusters bit for bit;
    every other slot is zero; slot i holds the cluster of sorted entry i,
    so the valid slots lie below the entry count."""
    cs = SETS[name]
    got, gvalid = cd.cluster_device(*cluster_sets.buffers(cs, CAP, "cpu"),
                                    cs.iou, capacity=CAP)
    want = host_clusters(cs)
    assert np.array_equal(got[gvalid].numpy().view(np.int32),
                          want.view(np.int32))
    assert not got[~gvalid].any()
    k = cs.entries().shape[0]
    assert not gvalid[k:].any()


def test_edge_sets_cover_the_design():
    """The sets reach what the kernel's design has to get right: a
    threshold that joins everything and one that joins nothing, seeds that
    do not join themselves, chains across words, one cluster of 1024."""
    counts = {name: host_clusters(cs).shape[0] for name, cs in SETS.items()}
    assert counts["mixed_-0.1"] == 1 and counts["all_join_1024"] == 1
    assert counts["mixed_1.0"] == 0
    assert counts["identical"] == 1 and counts["at_threshold_0.2"] == 2
    assert counts["at_threshold_0.5"] == 2
    for name in ("words_33", "words_1024", "words_4096", "holes"):
        assert 1 < counts[name] < SETS[name].entries().shape[0]
    holes = SETS["holes"]
    assert holes.count < holes.dets.shape[0] and not holes.valid.all()
    zero = SETS["scale0_0.2"].entries()
    assert (zero[:, 2] == 0).sum() >= 5
    mixed = SETS["mixed_0.2"].entries()
    assert (mixed[:, :2] < 0).any() and (mixed[:, :2] % 1 != 0).any()
