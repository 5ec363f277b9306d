"""Mix-presentation selection (a copy of iamf_tpu/core/presentation.py with
its imports redirected: the reference module imports core/stream.py,
which imports JAX).

Layout-match scoring and best-presentation/loudness selection mirroring
iamf_decoder_get_best_mix_presentation (IAMF_decoder.c:3083-3109, scoring
:2997-3028, loudness selection :3030-3059): exact layout match scores 100,
otherwise 50 +/- the channel-count difference.
"""

from __future__ import annotations

from typing import Optional

from ..constants import LayoutType, q78_to_db

from .stream import OutputLayout


def layout_match_score(out_layout: OutputLayout, target) -> int:
    """Score one of a sub-mix's measured layouts against the playback
    layout (iamf_decoder_get_best_mix_presentation inner loop)."""
    s = 0
    if target.type == out_layout.type:
        if out_layout.type == LayoutType.BINAURAL:
            s = 100
        elif target.sound_system == out_layout.sound_system:
            s = 100
    if not s:
        s = 50
        if target.type == LayoutType.SS_CONVENTION:
            chs = OutputLayout(
                type=LayoutType.SS_CONVENTION,
                sound_system=target.sound_system,
            ).channels
        else:
            chs = 2
        if out_layout.channels < chs:
            s += chs - out_layout.channels
        else:
            s -= out_layout.channels - chs
    return s


def best_mix_presentation(db, out_layout: OutputLayout,
                          mix_presentation_id: Optional[int] = None):
    """Pick the mix presentation to enable: the explicitly requested id if
    present, else the highest layout-match score."""
    mps = db.mix_presentations
    if not mps:
        return None
    if len(mps) == 1:
        return mps[0]
    if mix_presentation_id is not None:
        mp = db.get_mix_presentation(mix_presentation_id)
        if mp is not None:
            return mp
    best, best_score = None, 0
    for mp in mps:
        score = max(
            (layout_match_score(out_layout, l)
             for l in mp.sub_mixes[0].layouts),
            default=0,
        )
        if score > best_score:
            best, best_score = mp, score
    return best


def best_loudness(mp, out_layout: OutputLayout) -> float:
    """Integrated loudness (dB) of the sub-mix layout best matching the
    playback layout (IAMF_decoder.c:3030-3059)."""
    sub = mp.sub_mixes[0]
    best_idx, best_score = -1, 0
    for i, l in enumerate(sub.layouts):
        score = layout_match_score(out_layout, l)
        if score > best_score:
            best_idx, best_score = i, score
    if best_idx < 0:
        return 0.0
    return q78_to_db(sub.loudness[best_idx].integrated_loudness)
