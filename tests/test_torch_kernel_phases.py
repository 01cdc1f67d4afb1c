"""The cut copies of ``utils/kernel_phases.py`` against the sources they cut.

Each cut replaces text in a kernel's own headers, and ``_build_cut`` refuses
a cut whose text is in none of them, but only on a machine with the card and
``nvcc``. Here, on the CPU, every cut of every kernel (``KERNELS``, the split
backward's ``SPLIT_CUTS`` in ``csrc/attention_split_bwd.cuh`` and the split
forward's ``SPLIT_FWD_CUTS`` in ``csrc/attention_split_fwd.cuh``) is held to
the sources as they stand, so that a source edit which moves a cut's text
shows before a chip run.
"""

import pytest

from video_vae_tpu_torch.ops._build import CSRC
from video_vae_tpu_torch.utils import kernel_phases as kp

CUTS = [(kernel, cut, headers, edits) for kernel, (_, headers, _, _, cuts) in sorted(kp.KERNELS.items())
        for cut, edits in cuts.items()]
CUTS += [("split", cut, (kp.SPLIT_HEADER,), edits) for cut, edits in kp.SPLIT_CUTS.items()]
CUTS += [("split-fwd", cut, (kp.SPLIT_FWD_HEADER,), edits) for cut, edits in kp.SPLIT_FWD_CUTS.items()]


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


def test_split_fwd_cuts_reach_each_kernel():
    """``--kernel 1|5 --split`` takes the forward's cuts: the P.V product, the exps
    and the ring's TMA loads for both, #5's first walk for #5 only and #1's LN +
    RoPE pass for #1 only; each text once in the header, so that a cut reaches
    the one place it names. ``--kernel 3|6 --split`` keeps the backward's."""
    header = (CSRC / kp.SPLIT_FWD_HEADER).read_text()
    shared = {"full", "no_pv", "no_exp", "no_ring_loads"}
    assert kp.split_cuts("1") == (kp.SPLIT_FWD_HEADER, {c: kp.SPLIT_FWD_CUTS[c] for c in (*shared, "no_norm_rope")})
    assert kp.split_cuts("5") == (kp.SPLIT_FWD_HEADER, {c: kp.SPLIT_FWD_CUTS[c] for c in (*shared, "no_walk1")})
    assert kp.split_cuts("3") == kp.split_cuts("6") == (kp.SPLIT_HEADER, kp.SPLIT_CUTS)
    assert set(kp.SPLIT_KERNELS) == {"1", "3", "5", "6"} and "1" not in kp.KERNELS
    for cut in ("no_pv", "no_exp", "no_ring_loads", "no_walk1", "no_norm_rope"):
        for old, _ in kp.SPLIT_FWD_CUTS[cut]:
            assert header.count(old) == 1, (cut, old)
    # every exp of the walks goes through exp2_ftz, whose one instruction no_exp cuts
    assert "exp2f(" not in header and header.count("exp2_ftz(") >= 4
