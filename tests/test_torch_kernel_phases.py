"""The cut copies of ``utils/kernel_phases.py`` against the sources they cut.

Each cut replaces text in a kernel's own headers, and ``_build_cut`` refuses
a cut whose text is in none of them, but only on a machine with the card and
``nvcc``. Here, on the CPU, every cut of every kernel (``KERNELS``, and the
split backward's ``SPLIT_CUTS`` in ``csrc/attention_split_bwd.cuh``) is held
to the sources as they stand, so that a source edit which moves a cut's text
shows before a chip run.
"""

import pytest

from video_vae_tpu_torch.ops._build import CSRC
from video_vae_tpu_torch.utils import kernel_phases as kp

CUTS = [(kernel, cut, headers, edits) for kernel, (_, headers, _, _, cuts) in sorted(kp.KERNELS.items())
        for cut, edits in cuts.items()]
CUTS += [("split", cut, (kp.SPLIT_HEADER,), edits) for cut, edits in kp.SPLIT_CUTS.items()]


@pytest.mark.parametrize("kernel,cut,headers,edits", CUTS, ids=[f"{c[0]}-{c[1]}" for c in CUTS])
def test_every_cut_finds_its_text(kernel, cut, headers, edits):
    texts = [(CSRC / h).read_text() for h in headers]
    for old, new in edits:
        assert any(old in t for t in texts), (kernel, cut, old)
        assert old != new


def test_split_cuts_cover_both_launches():
    """The split backward's cuts reach both launches: the query side's walk and
    dq product, the key side's dv and dk products, both rings' loads."""
    header = (CSRC / kp.SPLIT_HEADER).read_text()
    for cut in ("no_walk1", "no_dq", "no_dvdk", "no_ring_loads", "no_exp"):
        assert cut in kp.SPLIT_CUTS
    loads = [old for old, _ in kp.SPLIT_CUTS["no_ring_loads"]]
    assert sum(header.count(old) for old in loads) == len(loads)  # each once: KB (query side), QB (key side)
