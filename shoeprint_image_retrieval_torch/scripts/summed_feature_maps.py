"""Per-channel NCC maps of one query/print pair and their channel sum.

    python -m shoeprint_image_retrieval_torch.scripts.summed_feature_maps \\
        QUERY.png PRINT.png [out.png] [--device cuda|cpu] [--weights-dir weights]

The port of ``scripts/summed_feature_maps.py``: a forensic examiner's view
of one score. Both images go through EfficientNetV2_M truncated at block 6
at full resolution (grayscale, CLAHE, ImageNet normalisation); every
channel's "same"-mode normalised cross-correlation map of the query's maps
against the print's is computed, and 8 of them are plotted beside the
channel sum, whose max over C (the title) is the retrieval score: it equals
the engine's score of the query's identity variant (rotation 0, scale 1)
against that print (:func:`engine_score`).

Runs on the card unless ``--device cpu`` is given. Weights come from
``{weights_dir}/EfficientNetV2_M.{npz,pth,pt}``; without one the backbone
takes seeded random init with a warning. Seeded init differs between this
port and the JAX package, so the two scripts plot the same maps only for
the same checkpoint. ``matplotlib`` is needed by :func:`plot` alone.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.efficientnet import Features
from ..models.registry import IMAGENET_MEAN, IMAGENET_STD
from ..models.weights import build_model
from ..ops.boxsum import EDGE_CROP
from ..ops.clahe import clahe_u8
from ..ops.ncc import normxcorr_same
from ..ops.ncc_direct import PackedVariants, VariantLayout, build_direct_cache, fold_template
from ..ops.ncc_kernel import score_ncc
from ..ops.preprocess import normalize_batch

MODEL, BLOCK = "EfficientNetV2_M", 6


def feature_maps(img_u8: np.ndarray, features: Features, device: torch.device | str,
                 name: str = "image") -> torch.Tensor:
    """(H, W) uint8 grayscale image -> its (C, h, w) f32 feature maps on
    ``device``, cropped to their valid size and then by ``EDGE_CROP`` px per
    edge: CLAHE (cv2's) on the whole image, ImageNet normalisation and the
    truncated forward, as the JAX script's ``maps_of``. Raises
    ``ValueError`` (naming ``name``) where the crop leaves nothing."""
    img = torch.from_numpy(np.array(img_u8, np.uint8)).to(device)
    hw = torch.tensor([img.shape], dtype=torch.int32, device=device)
    x = normalize_batch(clahe_u8(img)[None], hw, IMAGENET_MEAN, IMAGENET_STD)
    with torch.inference_mode():
        y, valid = features(x, hw)
    vh, vw = valid[0].tolist()
    if min(vh, vw) <= 2 * EDGE_CROP:
        raise ValueError(f"{name}: its {vh} x {vw} feature maps are empty after the "
                         f"{EDGE_CROP}-px edge crop; the image ({img.shape[0]} x "
                         f"{img.shape[1]} px) is too small")
    return y[0, :, EDGE_CROP : vh - EDGE_CROP, EDGE_CROP : vw - EDGE_CROP]


def channel_maps(q: torch.Tensor, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, float]:
    """(C, hq, wq) query and (C, hp, wp) print maps -> (corr (C, hp, wp),
    summed (hp, wp), score): each channel's "same"-mode NCC map, their sum
    and ``summed.max() / C``, all channels in one batched call."""
    corr = normxcorr_same(q, p)
    summed = corr.sum(dim=0)
    return corr, summed, float(summed.max()) / q.shape[0]


def engine_score(q: torch.Tensor, p: torch.Tensor) -> float:
    """The engine's direct score of the query's identity variant against the
    print, for the edge-cropped maps :func:`feature_maps` gives: the engine's
    packing (``build_direct_cache``, ``fold_template``, ``PackedVariants``)
    and ``ops/ncc_kernel.score_ncc`` — the NCC kernel on a CUDA tensor, its
    plain version on the CPU. Equals :func:`channel_maps`'s score."""
    dev = q.device
    # the engine crops EDGE_CROP px per edge itself: give it the maps uncropped
    q_raw, p_raw = (F.pad(m, (EDGE_CROP,) * 4)[None] for m in (q, p))
    q_hw = torch.tensor([q_raw.shape[-2:]], dtype=torch.int32, device=dev)
    p_hw = torch.tensor([p_raw.shape[-2:]], dtype=torch.int32, device=dev)
    cache = build_direct_cache(p_raw, p_hw)
    packed = PackedVariants(fold_template(q_raw, q_hw, tuple(q.shape[-2:])), q_hw - 2 * EDGE_CROP)
    return float(score_ncc(cache, packed, VariantLayout((1,), 1), q.shape[0])[0, 0])


def plot(corr: torch.Tensor, summed: torch.Tensor, score: float, out_path, n_show: int = 8) -> None:
    """The JAX script's figure: the first ``n_show`` channel maps and the
    summed map titled with the score, saved at 120 dpi."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    corr, summed = corr.cpu().numpy(), summed.cpu().numpy()
    fig, axes = plt.subplots(1, n_show + 1, figsize=(3 * (n_show + 1), 3))
    for i in range(n_show):
        axes[i].imshow(corr[i], cmap="viridis")
        axes[i].set_title(f"channel {i}")
        axes[i].axis("off")
    axes[-1].imshow(summed, cmap="magma")
    axes[-1].set_title(f"summed (score={score:.4f})")
    axes[-1].axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv: list[str] | None = None) -> None:
    from PIL import Image

    parser = argparse.ArgumentParser(
        prog="python -m shoeprint_image_retrieval_torch.scripts.summed_feature_maps")
    parser.add_argument("query")
    parser.add_argument("print_path", metavar="print")
    parser.add_argument("out", nargs="?", default="summed_feature_maps.png")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--weights-dir", default="weights")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    features = build_model(MODEL, BLOCK, args.weights_dir, dev)
    q, p = (feature_maps(np.asarray(Image.open(path).convert("L")), features, dev, path)
            for path in (args.query, args.print_path))
    corr, summed, score = channel_maps(q, p)
    plot(corr, summed, score, args.out)
    print(f"wrote {args.out} (score {score:.6f})")


if __name__ == "__main__":
    main()
