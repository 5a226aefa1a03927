"""Misregistration checker and aligner, as ``sshslie_tpu/align.py``: the
reference's MATLAB ``misregistration.m``. numpy and scipy only.

For each low / ground-truth cube pair matched by basename (``.mat`` or ENVI
``.hdr``):
  1. a 2D projection of each cube ('band' | 'mean' | 'median' | 'pca',
     misregistration.m:176-198);
  2. the global translation by FFT phase correlation with a subpixel
     refinement (in place of imregcorr, misregistration.m:105-107);
  3. the low projection warped, and the residual misalignment measured by a
     dense pyramidal Lucas-Kanade flow (in place of opticalFlowLK,
     misregistration.m:211-222), or where the flow is degenerate by an edge
     distance (Sobel edges and a Euclidean distance transform, in place of
     the Canny/bwdist proxy of misregistration.m:228-235);
  4. the pairs over the shift or flow thresholds flagged; a CSV report sorted
     by severity, preview PNGs of the flagged pairs, and optionally the
     aligned low cube, every band shifted alike (misregistration.m:118-133).

``python -m sshslie_torch.align --low_dir L --gt_dir G --out_csv r.csv
[--save_aligned DIR] [--preview_dir P]``
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from glob import glob
from typing import List, Optional, Tuple

import numpy as np
import scipy.ndimage as ndi

from sshslie_torch.utils.io_hsi import load_hsi, save_hsi


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def project_2d(cube: np.ndarray, method: str = "median", band: int = 0) -> np.ndarray:
    """Collapse (H, W, C) to a 2D image for alignment (misregistration.m:176-198)."""
    if method == "band":
        b = int(np.clip(band, 0, cube.shape[2] - 1))
        return cube[:, :, b].astype(np.float64)
    if method == "mean":
        return cube.mean(axis=2).astype(np.float64)
    if method == "median":
        return np.median(cube, axis=2).astype(np.float64)
    if method == "pca":
        h, w, c = cube.shape
        x = cube.reshape(-1, c).astype(np.float64)
        x = x - x.mean(axis=0)
        # PC-1 scores via the C×C covariance eigenvector — identical (up to
        # sign, anchored below) to the first left singular vector, without
        # the H·W×C SVD whose U allocation alone is ~10 GB for a
        # 2048²×300 cube.
        _, vecs = np.linalg.eigh(x.T @ x)
        img = (x @ vecs[:, -1]).reshape(h, w)
        # SVD sign is data-dependent; anchor it to the mean projection so the
        # low and GT cubes project with the same polarity — otherwise phase
        # correlation runs on anti-correlated images and the shift is bogus.
        mean_proj = cube.mean(axis=2)
        if np.dot(img.ravel() - img.mean(),
                  mean_proj.ravel() - mean_proj.mean()) < 0:
            img = -img
        return _rescale01(img)
    raise ValueError(f"unknown projection method {method!r}")


def _rescale01(img: np.ndarray) -> np.ndarray:
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


# ---------------------------------------------------------------------------
# translation estimation (phase correlation, subpixel)
# ---------------------------------------------------------------------------

def phase_correlation_shift(moving: np.ndarray, fixed: np.ndarray) -> Tuple[float, float]:
    """(dy, dx) such that shifting ``moving`` by it aligns it to ``fixed``.

    FFT cross-power spectrum peak with parabolic subpixel interpolation —
    the same translation model as imregcorr(..., 'translation').
    """
    f1 = np.fft.fft2(moving)
    f2 = np.fft.fft2(fixed)
    cross = f2 * np.conj(f1)
    denom = np.abs(cross)
    denom[denom == 0] = 1.0
    corr = np.fft.ifft2(cross / denom).real
    peak = np.unravel_index(np.argmax(corr), corr.shape)

    def subpixel(axis_len: int, idx: int, line: np.ndarray) -> float:
        prev = line[(idx - 1) % axis_len]
        cur = line[idx]
        nxt = line[(idx + 1) % axis_len]
        denom_ = 2 * cur - prev - nxt
        frac = 0.5 * (nxt - prev) / denom_ if abs(denom_) > 1e-12 else 0.0
        pos = idx + np.clip(frac, -0.5, 0.5)
        if pos > axis_len / 2:
            pos -= axis_len
        return float(pos)

    dy = subpixel(corr.shape[0], peak[0], corr[:, peak[1]])
    dx = subpixel(corr.shape[1], peak[1], corr[peak[0], :])
    return dy, dx


def warp_translate(
    img: np.ndarray, dy: float, dx: float, fill: Optional[float] = None
) -> np.ndarray:
    """Shift a 2D image by (dy, dx) with bilinear sampling and constant fill
    (imwarp with FillValues, misregistration.m:111-113)."""
    if fill is None:
        fill = float(np.median(img))
    return ndi.shift(img, (dy, dx), order=1, mode="constant", cval=fill)


# ---------------------------------------------------------------------------
# residual misalignment proxy
# ---------------------------------------------------------------------------

def sobel_edges(img: np.ndarray, pct: float = 90.0) -> np.ndarray:
    """Boolean edge map: Sobel gradient magnitude over its ``pct`` percentile
    (replacing MATLAB's Canny in the proxy; the ranking behavior is what the
    report consumes, not the exact detector)."""
    img = _rescale01(ndi.gaussian_filter(img, 0.8))
    gx = ndi.sobel(img, axis=1)
    gy = ndi.sobel(img, axis=0)
    mag = np.hypot(gx, gy)
    thresh = np.percentile(mag, pct)
    return mag > max(thresh, 1e-12)


def edge_misalign_proxy(warped: np.ndarray, fixed: np.ndarray) -> Tuple[float, float]:
    """Mean / p95 symmetric edge-to-edge distance (misregistration.m:219-228)."""
    e1 = sobel_edges(warped)
    e2 = sobel_edges(fixed)
    if not e1.any() or not e2.any():
        return float("nan"), float("nan")
    d1 = ndi.distance_transform_edt(~e1)
    d2 = ndi.distance_transform_edt(~e2)
    dists = np.concatenate([d1[e2].ravel(), d2[e1].ravel()])
    return float(np.mean(dists)), float(np.percentile(dists, 95))


# ---------------------------------------------------------------------------
# residual motion: dense pyramidal Lucas-Kanade (misregistration.m:211-222)
# ---------------------------------------------------------------------------

def _lk_level(ref: np.ndarray, mov: np.ndarray, win: int, noise: float):
    """One dense LK solve: per-pixel 2×2 structure-tensor system, gated by
    the smaller eigenvalue (MATLAB opticalFlowLK's NoiseThreshold)."""
    ix = ndi.sobel(ref, axis=1) / 8.0
    iy = ndi.sobel(ref, axis=0) / 8.0
    it = mov - ref

    def w(a):
        return ndi.uniform_filter(a, win)

    sxx, syy, sxy = w(ix * ix), w(iy * iy), w(ix * iy)
    sxt, syt = w(ix * it), w(iy * it)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    eigmin = 0.5 * (tr - np.sqrt(np.maximum(tr * tr - 4.0 * det, 0.0)))
    ok = eigmin > noise
    det_safe = np.where(ok & (np.abs(det) > 1e-12), det, 1.0)
    vx = np.where(ok, (sxy * syt - syy * sxt) / det_safe, 0.0)
    vy = np.where(ok, (sxy * sxt - sxx * syt) / det_safe, 0.0)
    return vy, vx, ok


def lucas_kanade_flow(
    ref: np.ndarray,
    mov: np.ndarray,
    levels: int = 3,
    win: int = 9,
    noise_thresh: float = 1e-4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense flow ref→mov: (Vy, Vx, valid_mask), coarse-to-fine.

    Equivalent of the reference's opticalFlowLK branch
    (misregistration.m:213-218, incl. the imgaussfilt(0.8) prefilter); the
    pyramid extends single-level LK beyond its ~1 px displacement range so
    residual motion after the global shift is still measurable.
    """
    ref = _rescale01(ndi.gaussian_filter(np.asarray(ref, np.float64), 0.8))
    mov = _rescale01(ndi.gaussian_filter(np.asarray(mov, np.float64), 0.8))
    pyr_r, pyr_m = [ref], [mov]
    for _ in range(levels - 1):
        if min(pyr_r[-1].shape) < 4 * win:
            break
        pyr_r.append(ndi.zoom(pyr_r[-1], 0.5, order=1))
        pyr_m.append(ndi.zoom(pyr_m[-1], 0.5, order=1))

    vy = np.zeros_like(pyr_r[-1])
    vx = np.zeros_like(pyr_r[-1])
    ok = np.ones(pyr_r[-1].shape, bool)
    for lvl in range(len(pyr_r) - 1, -1, -1):
        r, m = pyr_r[lvl], pyr_m[lvl]
        if vy.shape != r.shape:
            scale_y = r.shape[0] / vy.shape[0]
            scale_x = r.shape[1] / vy.shape[1]
            vy = ndi.zoom(vy, (scale_y, scale_x), order=1) * scale_y
            vx = ndi.zoom(vx, (scale_y, scale_x), order=1) * scale_x
        # Warp mov back by the current estimate, then solve for the update.
        yy, xx = np.meshgrid(
            np.arange(r.shape[0], dtype=np.float64),
            np.arange(r.shape[1], dtype=np.float64),
            indexing="ij",
        )
        m_w = ndi.map_coordinates(m, [yy + vy, xx + vx], order=1, mode="nearest")
        dvy, dvx, ok = _lk_level(r, m_w, win, noise_thresh)
        vy = vy + dvy
        vx = vx + dvx
    return vy, vx, ok


def residual_motion(
    warped: np.ndarray, fixed: np.ndarray, method: str = "lk"
) -> Tuple[float, float]:
    """Mean / p95 residual-motion magnitude after the global alignment.

    ``lk``: flow magnitudes over reliable pixels (misregistration.m:216-218's
    mean/prctile-95 over |flow|), falling back to the edge proxy when fewer
    than 1% of pixels pass the noise gate (the reference's catch branch,
    misregistration.m:219-222). ``proxy``: edge distances directly.
    """
    if method == "proxy":
        return edge_misalign_proxy(warped, fixed)
    vy, vx, ok = lucas_kanade_flow(fixed, warped)
    if ok.mean() < 0.01:
        return edge_misalign_proxy(warped, fixed)
    mag = np.hypot(vy, vx)[ok]
    return float(np.mean(mag)), float(np.percentile(mag, 95))


# ---------------------------------------------------------------------------
# batch checker
# ---------------------------------------------------------------------------

@dataclass
class PairResult:
    file_low: str
    file_gt: str
    dx: float = float("nan")
    dy: float = float("nan")
    shift_px: float = float("nan")
    mean_flow: float = float("nan")
    p95_flow: float = float("nan")
    flag_misaligned: bool = False
    proj_method: str = "median"


@dataclass
class AlignOptions:
    proj_method: str = "median"        # 'band' | 'mean' | 'median' | 'pca'
    band_for_vis: int = 0
    shift_thresh: float = 1.0
    flow_thresh: float = 0.8
    flow_method: str = "lk"             # 'lk' (opticalFlowLK equiv.) | 'proxy'
    save_aligned_dir: str = ""          # '' to skip saving aligned cubes
    max_previews: int = 30
    mat_key: str = "data"
    verbose: bool = True


def _resize_nearest_2d(cube: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Per-band nearest resize (imresize3nearest2D, misregistration.m:184-190)."""
    h, w = hw
    ih, iw, _ = cube.shape
    if (ih, iw) == (h, w):
        return cube
    ridx = np.floor(np.arange(h) * ih / h).astype(int)
    cidx = np.floor(np.arange(w) * iw / w).astype(int)
    return cube[ridx][:, cidx]


def check_misregistration_hsi(
    low_dir: str,
    gt_dir: str,
    out_csv: str,
    preview_dir: str = "",
    opts: Optional[AlignOptions] = None,
) -> List[PairResult]:
    """Batch misregistration check + optional per-band alignment.

    Returns the per-pair results (also written, severity-sorted, to
    ``out_csv``). Preview PNGs are emitted only for flagged pairs.
    """
    opts = opts or AlignOptions()

    def _cubes(root: str) -> List[str]:
        # .mat plus ENVI .hdr pairs (load_hsi dispatches on the extension)
        return sorted(
            glob(os.path.join(root, "**", "*.mat"), recursive=True)
            + glob(os.path.join(root, "**", "*.hdr"), recursive=True)
        )

    low_files = {}
    for f in _cubes(low_dir):
        stem = os.path.splitext(os.path.basename(f))[0].lower()
        if stem in low_files:
            # Recursive glob can surface basename collisions (same stem in
            # two subdirs, or foo.mat next to foo.hdr) — pairing is by
            # basename, so a silent overwrite would align GT cubes against
            # the wrong file. Keep the first (sorted) and say so.
            print(f"warning: duplicate cube basename {stem!r}: keeping "
                  f"{low_files[stem]}, ignoring {f}")
            continue
        low_files[stem] = f
    gt_files = _cubes(gt_dir)
    pairs = [
        (low_files[os.path.splitext(os.path.basename(g))[0].lower()], g)
        for g in gt_files
        if os.path.splitext(os.path.basename(g))[0].lower() in low_files
    ]
    if not pairs:
        raise ValueError(
            f"No matching cube filenames (.mat/.hdr) between {low_dir} and {gt_dir}"
        )
    if opts.verbose:
        print(f"Found {len(pairs)} matching pairs.")

    if preview_dir:
        os.makedirs(preview_dir, exist_ok=True)
    if opts.save_aligned_dir:
        os.makedirs(opts.save_aligned_dir, exist_ok=True)

    results: List[PairResult] = []
    previews = 0
    for f_low, f_gt in pairs:
        res = PairResult(file_low=os.path.relpath(f_low, low_dir),
                         file_gt=os.path.relpath(f_gt, gt_dir),
                         proj_method=opts.proj_method)
        try:
            # load_hsi (not raw loadmat): handles v7.3/HDF5 cubes too — the
            # MATLAB original read those natively, and save_hsi auto-emits
            # v7.3 for cubes ≥ 2 GiB.
            low = np.asarray(
                load_hsi(f_low, mat_key=opts.mat_key, normalization=None),
                dtype=np.float64,
            )
            gt = np.asarray(
                load_hsi(f_gt, mat_key=opts.mat_key, normalization=None),
                dtype=np.float64,
            )
            h = min(low.shape[0], gt.shape[0])
            w = min(low.shape[1], gt.shape[1])
            low = _resize_nearest_2d(low, (h, w))
            gt = _resize_nearest_2d(gt, (h, w))

            low_proj = _rescale01(project_2d(low, opts.proj_method, opts.band_for_vis))
            gt_proj = _rescale01(project_2d(gt, opts.proj_method, opts.band_for_vis))

            dy, dx = phase_correlation_shift(low_proj, gt_proj)
            shift_px = float(np.hypot(dx, dy))
            warped = warp_translate(low_proj, dy, dx)
            mean_flow, p95_flow = residual_motion(
                warped, gt_proj, method=opts.flow_method
            )
            flag = (shift_px > opts.shift_thresh) or (mean_flow > opts.flow_thresh)

            res.dx, res.dy, res.shift_px = float(dx), float(dy), shift_px
            res.mean_flow, res.p95_flow = mean_flow, p95_flow
            res.flag_misaligned = bool(flag)

            if preview_dir and flag and previews < opts.max_previews:
                base = os.path.splitext(os.path.basename(f_gt))[0]
                _save_preview(low_proj, gt_proj, warped, res,
                              os.path.join(preview_dir, f"{base}_preview.png"))
                previews += 1

            if opts.save_aligned_dir:
                fill = float(np.median(low))
                aligned = np.stack(
                    [warp_translate(low[:, :, b], dy, dx, fill)
                     for b in range(low.shape[2])], axis=-1,
                ).astype(np.float32)
                base = os.path.splitext(os.path.basename(f_low))[0]
                # save_hsi, not raw savemat: atomic tmp+rename, and cubes
                # past scipy's 2**31-byte limit auto-route to v7.3 (the
                # loader above advertises reading such cubes).
                save_hsi(os.path.join(opts.save_aligned_dir, base + ".mat"),
                         aligned, key=opts.mat_key)
        except Exception as e:  # keep batch going like the MATLAB try/catch
            print(f"Failed on pair {f_low} | {f_gt}: {e}")
        results.append(res)

    # severity sort: flagged first, then p95 flow, then shift
    def _key(r: PairResult):
        return (
            r.flag_misaligned,
            r.p95_flow if np.isfinite(r.p95_flow) else -1,
            r.shift_px if np.isfinite(r.shift_px) else -1,
        )

    results.sort(key=_key, reverse=True)
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    with open(out_csv, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["file_low", "file_gt", "dx", "dy", "shift_px",
                         "mean_flow", "p95_flow", "flag_misaligned", "projMethod"])
        for r in results:
            writer.writerow([r.file_low, r.file_gt, r.dx, r.dy, r.shift_px,
                             r.mean_flow, r.p95_flow, r.flag_misaligned, r.proj_method])
    if opts.verbose:
        print(f"Saved report to {out_csv}")
    return results


def _save_preview(low: np.ndarray, gt: np.ndarray, warped: np.ndarray,
                  res: PairResult, out_png: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    diff = np.abs(warped - gt)
    fig, axes = plt.subplots(2, 3, figsize=(12, 8))
    panels = [
        (low, "Low proj"), (gt, "GT proj"),
        (warped, f"Low warped (dx={res.dx:.2f}, dy={res.dy:.2f})"),
        (sobel_edges(low).astype(float), "Edges: Low"),
        (sobel_edges(warped).astype(float), "Edges: Warped Low"),
        (diff, f"Abs diff | shift={res.shift_px:.2f} | "
               f"meanFlow={res.mean_flow:.2f} | p95={res.p95_flow:.2f}"),
    ]
    for ax, (img, title) in zip(axes.ravel(), panels):
        ax.imshow(img, cmap="gray")
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(out_png, dpi=150)
    plt.close(fig)


def main(argv=None):
    """CLI for the batch checker — the call surface MATLAB users had via
    ``check_misregistration_hsi(lowDir, gtDir, outCsv, previewDir, opts)``
    (misregistration.m:4-15)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Check (and optionally fix) low/GT HSI misregistration."
    )
    ap.add_argument("--low_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--out_csv", required=True)
    ap.add_argument("--preview_dir", default="")
    ap.add_argument("--proj_method", default="median",
                    choices=("band", "mean", "median", "pca"))
    ap.add_argument("--band", type=int, default=0)
    ap.add_argument("--shift_thresh", type=float, default=1.0)
    ap.add_argument("--flow_thresh", type=float, default=0.8)
    ap.add_argument("--flow_method", default="lk", choices=("lk", "proxy"))
    ap.add_argument("--save_aligned", default="",
                    help="directory for shift-corrected low cubes ('' = skip)")
    ap.add_argument("--max_previews", type=int, default=30)
    ap.add_argument("--mat_key", default="data")
    args = ap.parse_args(argv)

    results = check_misregistration_hsi(
        args.low_dir, args.gt_dir, args.out_csv, args.preview_dir,
        AlignOptions(
            proj_method=args.proj_method, band_for_vis=args.band,
            shift_thresh=args.shift_thresh, flow_thresh=args.flow_thresh,
            flow_method=args.flow_method, save_aligned_dir=args.save_aligned,
            max_previews=args.max_previews, mat_key=args.mat_key,
        ),
    )
    flagged = sum(r.flag_misaligned for r in results)
    print(f"{len(results)} pairs checked, {flagged} flagged.")
    return results


if __name__ == "__main__":
    main()
