"""ToMe token-merge visualisation.

Port of ``qa_tiger_tpu/pipeline/vis.py`` (the reference's
``tome.vis.make_visualization``, src/tome/vis.py:32-88): map each final
merged token group back to its source patches through the provenance
matrix (``source.argmax`` over groups), tint each group with a random
colour, and darken the group borders so that merged regions read as
contiguous blobs. numpy in, numpy out; a ``torch.Tensor`` provenance matrix
(``models.vit.vit_forward(..., trace_source=True)["source"][i]``, on either
device) is moved to the host first.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(source) -> np.ndarray:
    if torch.is_tensor(source):
        return source.detach().float().cpu().numpy()
    return np.asarray(source)


def generate_colormap(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0.25, 1.0, size=(n, 3)).astype(np.float32)


def group_assignment(source, class_token: bool = True) -> np.ndarray:
    """[grid, grid] patch -> group map from a [groups, tokens] provenance
    matrix: the deterministic core shared with the reference's
    ``source.argmax(dim=1)`` (src/tome/vis.py:55-58); everything downstream
    of it is rendering style."""
    src = _host(source)
    if class_token:
        src = src[:, 1:]  # drop the class token's column
    num_patches = src.shape[1]
    grid = int(round(np.sqrt(num_patches)))
    if grid * grid != num_patches:
        raise ValueError(f"{num_patches} patches do not make a square grid")
    # each source patch belongs to the group with the largest provenance weight
    return np.argmax(src, axis=0).reshape(grid, grid)


def make_visualization(image: np.ndarray, source, patch_size: int = 16,
                       class_token: bool = True, alpha: float = 0.5,
                       seed: int = 0) -> np.ndarray:
    """Overlay merged-token groups on an image.

    image: [H, W, 3] float in [0, 1]; source: [groups, tokens] provenance
    matrix. Returns [H, W, 3]."""
    img = np.asarray(image, np.float32)
    num_groups = _host(source).shape[0]
    assignment = group_assignment(source, class_token)
    cmap = generate_colormap(num_groups, seed)

    h, w = img.shape[:2]
    mask = np.kron(assignment, np.ones((patch_size, patch_size), int))
    mask = mask[:h, :w]
    colors = cmap[mask]

    out = (1 - alpha) * img + alpha * colors
    # darken group borders (neighbour disagreement)
    border = np.zeros((h, w), bool)
    border[:-1, :] |= mask[:-1, :] != mask[1:, :]
    border[:, :-1] |= mask[:, :-1] != mask[:, 1:]
    out[border] *= 0.4
    return np.clip(out, 0.0, 1.0)
