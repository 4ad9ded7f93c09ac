"""Feature dumps, ``featdata_*.npz`` with a 2-D projection (counterpart of
``audio_fewshot_tpu/utils/features.py``).

One ``plots/featdata_<timestamp>_<ep>.npz`` per episode, with the
reference's keys: ``raw_features`` ``[way · (shot + query), D]`` in
per-class blocks (the class's supports, then its query clips), ``shot``,
``way``, ``query``, ``timestamp``, ``normalize``, ``method``.  A query
clip's row is its first valid segment's feature (a clip without one: a zero
row and a warning).  Where sklearn is importable, ``features_2d`` (L2
normalise → PCA(≤ 50) → t-SNE(2, seed 0, ``init="pca"``), or UMAP when
asked for and importable) and ``projection_used``; without it a warning and
no projection.  ``Test`` writes it for the first test batch with
``dump_features: true``.
"""

from __future__ import annotations

import datetime
import os
from typing import List

import numpy as np
import torch


def _first_segment_rows(qry: np.ndarray, clip_ids: np.ndarray, mask: np.ndarray,
                        num_clips: int, logger=None) -> np.ndarray:
    """``[G, D]`` segment features → ``[num_clips, D]``, each clip's first
    valid segment."""
    rows = np.zeros((num_clips, qry.shape[-1]), dtype=qry.dtype)
    empty = []
    for clip in range(num_clips):
        idx = np.nonzero((clip_ids == clip) & (mask > 0))[0]
        if idx.size:
            rows[clip] = qry[idx[0]]
        else:
            empty.append(clip)
    if empty and logger is not None:
        logger.warning("featdata: query clips %s have no valid segment — their feature rows "
                       "are zero-filled", empty)
    return rows


def _project_2d(feat: np.ndarray, normalize: bool, method: str, logger=None):
    """``(coords or None, projection used)``: L2 normalise → PCA(min(50, D,
    n)) → UMAP(2) for ``method == "umap"`` where umap imports, else t-SNE(2,
    ``random_state=0``, ``init="pca"``, perplexity clamped below n)."""
    try:
        from sklearn.decomposition import PCA
        from sklearn.manifold import TSNE
        from sklearn.preprocessing import normalize as sk_normalize
    except ImportError:
        if logger is not None:
            logger.warning("sklearn unavailable — featdata saved without features_2d")
        return None, "none"
    n, d = feat.shape
    proc = sk_normalize(feat, norm="l2") if normalize else feat
    proc = PCA(n_components=min(50, d, n), random_state=0).fit_transform(proc)
    if method == "umap":
        try:
            import umap

            return umap.UMAP(n_components=2, random_state=0).fit_transform(proc).astype(
                np.float32), "umap"
        except ImportError:
            if logger is not None:
                logger.warning("dump_features_method=umap but umap is unavailable — falling "
                               "back to t-SNE")
    perplexity = min(30.0, max(2.0, (n - 1) / 3.0))
    tsne = TSNE(n_components=2, random_state=0, init="pca", perplexity=perplexity)
    return tsne.fit_transform(proc).astype(np.float32), "tsne"


@torch.no_grad()
def dump_episode_features(method, batch, out_dir: str, *, normalize: bool = True,
                          proj_method: str = "tsne", logger=None) -> List[str]:
    """Embed one (materialised) ``EpisodeBatch`` with ``method`` as it stands
    and write a ``featdata_*.npz`` per episode under ``out_dir/plots/``.
    Returns the written paths."""
    sup_f, qry_f = method.embed(batch)
    e = sup_f.shape[0]
    sup = sup_f.float().reshape(e, sup_f.shape[1], -1).cpu().numpy()
    qry = qry_f.float().reshape(e, qry_f.shape[1], -1).cpu().numpy()
    sup_t = batch.support_target.cpu().numpy()
    qry_t = batch.query_target.cpu().numpy()
    clip_ids = batch.query_clip.cpu().numpy()
    mask = batch.query_mask.cpu().numpy()

    way = int(sup_t.max()) + 1 if sup_t.size else 0
    shot = sup.shape[1] // max(way, 1)
    num_clips = qry_t.shape[-1]
    query = num_clips // max(way, 1)

    plots = os.path.join(out_dir, "plots")
    os.makedirs(plots, exist_ok=True)
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    paths: List[str] = []
    for ep in range(e):
        clip_rows = _first_segment_rows(qry[ep], clip_ids[ep], mask[ep], num_clips, logger)
        feat = np.concatenate([block for c in range(way) for block in (
            sup[ep][sup_t[ep] == c], clip_rows[qry_t[ep] == c])], axis=0)
        if feat.shape[0] != way * (shot + query):
            raise ValueError(f"featdata: {feat.shape[0]} rows, expected way · (shot + query) = "
                             f"{way} · ({shot} + {query})")
        feat_2d, used = _project_2d(feat, normalize, proj_method, logger)
        path = os.path.join(plots, f"featdata_{timestamp}_{ep:03d}.npz")
        payload = dict(raw_features=feat, shot=shot, way=way, query=query, timestamp=timestamp,
                       normalize=normalize, method=proj_method)
        if feat_2d is not None:
            payload.update(features_2d=feat_2d, projection_used=used)
        np.savez(path, **payload)
        paths.append(path)
    if logger is not None:
        logger.info("saved %d featdata dump(s) under %s", len(paths), plots)
    return paths
