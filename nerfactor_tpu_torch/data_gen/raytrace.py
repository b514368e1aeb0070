"""Batched ray-mesh first-hit intersection in PyTorch (counterpart of
data_gen_tpu/raytrace.py; the reference casts with Embree,
data_gen/dtu_mvs/surf_from_mvs.py:66).

A dense Moller-Trumbore test over (ray chunk) x (triangle chunk) tiles,
reduced with a running nearest-hit minimum, on the device the caller
names; nothing moves to the host. As in the JAX package: rays are padded
by repeating the last ray and triangles by zero (never-hit) triangles;
within a tile the first minimum wins, a later triangle chunk only on a
strictly nearer hit, and a ray with no hit gets ``t = inf`` and index -1.
The tile's temporaries are (ray chunk, triangle chunk) arrays, one a
vector component, so their size is set by the chunks and not by the
number of rays.

Every step is a separate elementwise operation on f32 (no fused
multiply-add, no reduction of unspecified order), so the card and the CPU
compute the same bits.
"""

import numpy as np
import torch

EPS = 1e-9


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _moller_trumbore(rayo, rayd, v0, e1, e2):
    """First-hit t of each ray against each triangle.

    Args:
      rayo, rayd: (R, 3).
      v0: (T, 3) triangle base vertices; e1, e2: (T, 3) edge vectors.

    Returns:
      t: (R, T), +inf where there is no hit.
    """
    o = [rayo[:, c:c + 1] for c in range(3)]  # (R, 1) each
    d = [rayd[:, c:c + 1] for c in range(3)]
    v0, e1, e2 = ([x[None, :, c] for c in range(3)] for x in (v0, e1, e2))
    pvec = _cross(d, e2)  # (R, T) each
    det = _dot(e1, pvec)
    valid = torch.abs(det) > EPS
    inv_det = torch.where(valid, 1.0 / det, torch.zeros_like(det))
    tvec = [o[c] - v0[c] for c in range(3)]
    u = _dot(tvec, pvec) * inv_det
    del pvec
    qvec = _cross(tvec, e1)
    del tvec
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = valid & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > EPS)
    return torch.where(hit, t, torch.full_like(t, float('inf')))


def _first_hit_chunk(rayo, rayd, tris, tri_chunk):
    """(R,3), (R,3), (Tpad,3,3) -> (t_min (R,), tri_idx (R,)), walking
    the triangle chunks in order."""
    t_min = torch.full((rayo.shape[0],), float('inf'), device=rayo.device)
    idx_min = torch.full((rayo.shape[0],), -1, dtype=torch.int64,
                         device=rayo.device)
    for base in range(0, tris.shape[0], tri_chunk):
        blk = tris[base:base + tri_chunk]
        v0 = blk[:, 0]
        t = _moller_trumbore(rayo, rayd, v0, blk[:, 1] - v0, blk[:, 2] - v0)
        t_blk, i_blk = torch.min(t, dim=1)  # the first minimum
        better = t_blk < t_min
        t_min = torch.where(better, t_blk, t_min)
        idx_min = torch.where(better, i_blk + base, idx_min)
    return t_min, idx_min


def _as_f32(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def intersect(rayo, rayd, vertices, faces, ray_chunk=4096, tri_chunk=8192,
              any_hit_only=False, device='cpu'):
    """First hit of N rays against a triangle mesh, on ``device``.

    Args:
      rayo, rayd: (N, 3) arrays or tensors (directions need not be unit).
      vertices: (V, 3); faces: (F, 3) int.
      any_hit_only: a hint only, as in the JAX package: occlusion queries
        run the same nearest-hit scan.

    Returns:
      hit (N,) bool, t (N,) float32 (inf without a hit), tri_idx (N,)
      int64 (-1 without a hit): tensors on ``device``.
    """
    del any_hit_only
    rayo, rayd = _as_f32(rayo, device), _as_f32(rayd, device)
    tris = _as_f32(np.asarray(vertices, np.float32)[
        np.asarray(faces, np.int64)], device)
    n_tris = tris.shape[0]
    tri_chunk = min(tri_chunk, max(256, n_tris))
    pad_t = (-n_tris) % tri_chunk
    if pad_t:
        tris = torch.cat([tris, tris.new_zeros((pad_t, 3, 3))], dim=0)
    n = rayo.shape[0]
    ray_chunk = min(ray_chunk, max(64, n))
    pad_r = (-n) % ray_chunk
    if pad_r:
        rayo = torch.cat([rayo, rayo[-1:].expand(pad_r, 3)], dim=0)
        rayd = torch.cat([rayd, rayd[-1:].expand(pad_r, 3)], dim=0)
    t_out, i_out = [], []
    for start in range(0, rayo.shape[0], ray_chunk):
        sl = slice(start, start + ray_chunk)
        t_c, i_c = _first_hit_chunk(rayo[sl], rayd[sl], tris, tri_chunk)
        t_out.append(t_c)
        i_out.append(i_c)
    t_out = torch.cat(t_out)[:n]
    i_out = torch.cat(i_out)[:n]
    return torch.isfinite(t_out), t_out, i_out


def face_normals(vertices, faces):
    """(F, 3) unit normals with right-hand winding, float32 (host)."""
    v = np.asarray(vertices, np.float64)[np.asarray(faces, np.int64)]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(norm, 1e-12)).astype(np.float32)
