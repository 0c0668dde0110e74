"""The classes of the port's models/mscale2.py, attnscale.py, basic.py and
deeper.py vs tpuseg's, f32 on the CPU, on the tiny WRN38 trunk from the
same converted weights (checks in tests/_torch_family.py): the eval forward
(n-scale where the class fuses scales) and the train forward, every output
< 1e-4 (ASDV3P_Paired's chained attention by its condition number), the
train-mode BN statistics by L1-relative."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_family import SIDE, check_eval, check_train, run_case
from _torch_port import max_abs, set_threads, to_np
from tpuseg.models import attnscale as jattnscale
from tpuseg.models import basic as jbasic
from tpuseg.models import deeper as jdeeper
from tpuseg.models import mscale2 as jmscale2
from tpuseg_torch.models import attnscale, basic, deeper, mscale2

set_threads()
# case -> (tpuseg class, port class, arguments both take)
CASES = {
    "MscaleV3Plus2": (jmscale2.MscaleV3Plus2, mscale2.MscaleV3Plus2,
                      dict(n_scales=(0.5, 1.0))),
    "Basic2": (jmscale2.Basic2, mscale2.Basic2, dict(n_scales=(0.5, 1.0))),
    # the plain head's padded 1x1 classifier
    "ASDV3P-plain": (jattnscale.ASDV3P, attnscale.ASDV3P,
                     dict(scales=(0.5, 1.0))),
    "ASDV3P-bn": (jattnscale.ASDV3P, attnscale.ASDV3P,
                  dict(scales=(0.5, 1.0), bn_head=True)),
    # trains on (0.5, 1.0), evaluates the chain over three scales
    "ASDV3P_Paired": (jattnscale.ASDV3P_Paired, attnscale.ASDV3P_Paired,
                      dict(inf_scales=(0.5, 1.0, 2.0), bn_head=True)),
    "Basic": (jbasic.Basic, basic.Basic, dict(seg_bot_ch=16)),
    "ASPPModel": (jbasic.ASPPModel, basic.ASPPModel,
                  dict(aspp_bot_ch=16, seg_bot_ch=16)),
    "DeeperS8": (jdeeper.DeeperS8, deeper.DeeperS8, {}),
}
# ASDV3P_Paired's eval chain divides by the sum of the second pair's two
# raw attention logits (attnscale.py:330-345), which passes within ~1e-4 of
# 0 at some pixels of a random net (|attn| up to 1.1e4 here), so the
# chained maps and the fused logits carry the f32 difference of the chain's
# inputs (< 2e-6) times the division's condition number (|a| + |b|) /
# |a + b|, up to ~1e4. The inputs (each pair's attention map, the
# per-scale logits) are held at 1e-4; the chained outputs at 1e-4 times
# that condition number, elementwise.
CHAINED = {"attn_1.0x", "attn_2.0x", "pred"}


@pytest.mark.parametrize("case", CASES)
def test_eval_forward_matches_tpuseg(case):
    check_eval(case, *CASES[case],
               skip=CHAINED if case == "ASDV3P_Paired" else ())


@pytest.mark.parametrize("case", CASES)
def test_train_forward_matches_tpuseg(case):
    check_train(case, *CASES[case])


def test_paired_eval_chain_matches_tpuseg():
    pev, _, _, jev, _, _, _, pmaps, jmaps = run_case(
        "ASDV3P_Paired", *CASES["ASDV3P_Paired"])
    assert len(pmaps) == len(jmaps) == 2  # pairs (0.5, 1.0), (1.0, 2.0)
    for got, want in zip(pmaps, jmaps):
        assert max_abs(got.permute(0, 2, 3, 1), want) < 1e-4
    # the condition of the division by a_lo + a_hi of the second pair,
    # at the input's size, where the chain divides
    pair = F.interpolate(torch.tensor(jmaps[1]).permute(0, 3, 1, 2)
                         .double(), size=(SIDE, SIDE), mode="bilinear")
    kappa = to_np((pair.abs().sum(1) / pair.sum(1).abs())[..., None])
    tol = {}
    for s in (0.5, 1.0, 2.0):
        attn = np.abs(jev[f"attn_{s}x"]).astype(np.float64)
        tol[s] = 1e-4 * np.maximum(1, attn) * (kappa if s > 0.5 else 1)
        diff = np.abs(to_np(pev[f"attn_{s}x"]) - jev[f"attn_{s}x"])
        assert (diff <= tol[s]).all(), s
    # the fused logits: the per-scale logits' tolerance times the attention
    # plus the attention's times the logits
    bound = sum(1e-4 * np.abs(jev[f"attn_{s}x"])
                + tol[s] * np.abs(jev[f"pred_{s}x"]) for s in tol)
    diff = np.abs(to_np(pev["pred"]) - jev["pred"])
    assert (diff <= np.maximum(1e-4, bound)).all()
