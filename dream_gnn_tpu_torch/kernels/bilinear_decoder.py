"""GCMC's bilinear decoder with a basis: a hand-written CUDA kernel and its
plain PyTorch version.

The decoder of GCMC (van den Berg, Kipf and Welling, arXiv:1706.02263,
eq. 5-6, without the paper's ordinal weight sharing), as DGL's
``examples/pytorch/gcmc`` ``BiDecoder`` runs it: for a rating of user i and
movie j, with B basis matrices P_b (D x D) and the combination a (R x B),

    s_b = u_i^T P_b v_j,        logit_r = sum_b a[r, b] s_b,

the R logits of a softmax over the rating levels.  ``UP = u P`` (every user
times every basis, one (n_users, D) @ (D, B*D) product) is computed first;
the kernel (``csrc/bilinear_decoder.cu``) gathers per rating a V row and
reduces the B dot products, and writes the logits once, class-major, (R, E):
each class's logits of the ratings are contiguous.

Slot order.  The ratings of a ``BilinearLayout`` are in slot order, sorted
by (user, movie), so that each user's UP row is read once; the logits come
in that order, and ``slot_labels`` puts the targets in it too.  The
backward sums the node gradients over tasks, runs of at most ``TASK``
ratings of one node (the slot order for users, the layout's movie order
for movies), so that no per-rating f32 row buffer is made and a movie with
tens of thousands of ratings is spread over many warps; each task writes a
partial row and a node's partial rows are added in task order.  Every sum
runs in a fixed order, so two launches give the same bits.

Backward, from the logits' cotangent g (R, E):

    ds_b = sum_r a[r, b] g_r,          da = g s^T,
    dUP_i = sum over user i's ratings of ds_b v_j  (the user pass),
    W_j   = sum over movie j's ratings of ds_b u_i (the movie pass),
    du = dUP P^T,  dP_b = u^T dUP_b,  dv = sum_b W_b P_b,

the last three as dense products.  All in float32 (the caller keeps TF32
off): the kernel's sums run in another order than the plain version's, and
the tests hold one to the other within 1e-5 of the largest value.

Dispatch.  CUDA tensors launch the kernels, CPU tensors run the plain
version; there is no fallback from one to the other.  ``LAUNCHES`` counts
the forward launches (``fwd``) and the backwards (``bwd``, each its two
passes and their task sums).  The kernels are built
for (R, B) = (10, 4), MovieLens' levels and DGL's basis count, and D of at
most 128; the plain version takes any.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from dream_gnn_tpu_torch.graph.csr import as_tensor, cut_runs
from dream_gnn_tpu_torch.kernels import cuda_build
from dream_gnn_tpu_torch.kernels.grid_decoder import stream_ptr
from dream_gnn_tpu_torch.utils.profiling import span

TASK = 128          # ratings of one node a task at most
USER_WARPS = 8192   # warps of the user pass (a fixed grid: fixed da order)
SHAPES = ((10, 4),)
PLAIN_BLOCK = 1 << 18
LAUNCHES = {"fwd": 0, "bwd": 0}

_lib = None


@dataclasses.dataclass(frozen=True)
class BilinearLayout:
    """The slot orders of one rating list, built once per list.  Index
    tensors are int32 on the list's device."""

    order: torch.Tensor       # slot -> rating of the input list (int64)
    src: torch.Tensor         # slot -> user, ascending
    dst: torch.Tensor         # slot -> movie
    u_task_node: torch.Tensor  # user task -> user
    u_task_beg: torch.Tensor  # (n_u_tasks + 1,) first slot of each task
    u_tptr: torch.Tensor      # (n_users + 1,) each user's tasks
    perm: torch.Tensor        # movie-order position -> slot
    m_src: torch.Tensor       # movie-order position -> user
    m_task_beg: torch.Tensor  # (n_m_tasks + 1,) first position of each task
    m_tptr: torch.Tensor      # (n_movies + 1,) each movie's tasks
    n_users: int
    n_movies: int

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]

    def slot_labels(self, x):
        """``x`` (a value per rating of the input list) in slot order."""
        x = as_tensor(x, None, self.order.device)
        return x[self.order]


def _tasks(node_of_pos: torch.Tensor, n_nodes: int, task: int):
    """(task_node, task_beg, tptr) of positions sorted by node: each node's
    run cut into pieces of at most ``task`` positions."""
    counts = torch.bincount(node_of_pos.long(), minlength=n_nodes)
    ptr = torch.zeros(n_nodes + 1, dtype=torch.int64,
                      device=node_of_pos.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    node, beg, tptr = cut_runs(ptr, task)
    return node.int(), beg.int(), tptr.int()


def build_bilinear_layout(src, dst, n_users: int, n_movies: int, device=None,
                          task: int = TASK) -> BilinearLayout:
    """The layout of ratings (src user, dst movie), one rating a pair."""
    src = as_tensor(src, torch.int64, device)
    dst = as_tensor(dst, torch.int64, src.device)
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError("build_bilinear_layout: src and dst must be (E,)")
    if src.numel() and (int(src.min()) < 0 or int(src.max()) >= n_users
                        or int(dst.min()) < 0 or int(dst.max()) >= n_movies):
        raise ValueError("build_bilinear_layout: an id is out of range")
    order = torch.argsort(src * n_movies + dst, stable=True)
    s, d = src[order], dst[order]
    u_node, u_beg, u_tptr = _tasks(s, n_users, task)
    perm = torch.argsort(d, stable=True)
    m_node, m_beg, m_tptr = _tasks(d[perm], n_movies, task)
    del m_node
    return BilinearLayout(order=order, src=s.int(), dst=d.int(),
                          u_task_node=u_node, u_task_beg=u_beg, u_tptr=u_tptr,
                          perm=perm.int(), m_src=s[perm].int(),
                          m_task_beg=m_beg, m_tptr=m_tptr, n_users=n_users,
                          n_movies=n_movies)


def basis_cat(p: torch.Tensor) -> torch.Tensor:
    """(B, D, D) -> (D, B*D): [P_1 | ... | P_B]."""
    b, d, _ = p.shape
    return p.permute(1, 0, 2).reshape(d, b * d)


# ---------------------------------------------------------------------------
# The plain version.

def bilinear_fwd_plain(up, v, a, layout: BilinearLayout) -> torch.Tensor:
    """Logits (R, E) in slot order; up (n_users, B, D)."""
    r = a.shape[0]
    out = up.new_empty((r, layout.n_edges))
    for lo in range(0, layout.n_edges, PLAIN_BLOCK):
        hi = min(layout.n_edges, lo + PLAIN_BLOCK)
        s = torch.einsum("ebk,ek->eb", up[layout.src[lo:hi].long()],
                         v[layout.dst[lo:hi].long()])
        out[:, lo:hi] = a @ s.T
    return out


def bilinear_bwd_plain(g, up, u, v, a, layout: BilinearLayout):
    """(dUP (n_users, B, D), da (R, B), W (n_movies, B, D)) of the
    cotangent g (R, E)."""
    b, d = up.shape[1], up.shape[2]
    dup = up.new_zeros(up.shape)
    w = up.new_zeros((layout.n_movies, b, d))
    da = a.new_zeros(a.shape)
    for lo in range(0, layout.n_edges, PLAIN_BLOCK):
        hi = min(layout.n_edges, lo + PLAIN_BLOCK)
        i, j = layout.src[lo:hi].long(), layout.dst[lo:hi].long()
        gb = g[:, lo:hi]
        ds = (a.T @ gb).T                                        # (e, B)
        s = torch.einsum("ebk,ek->eb", up[i], v[j])
        da += gb @ s
        dup.index_add_(0, i, ds[:, :, None] * v[j][:, None, :])
        w.index_add_(0, j, ds[:, :, None] * u[i][:, None, :])
    return dup, da, w


# ---------------------------------------------------------------------------
# The kernels.

def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("bilinear_decoder")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.bilinear_fwd.argtypes = [p] * 6 + [i64, i, i, i, p]
        lib.bilinear_bwd_user.argtypes = [p] * 7 + [i, i64, i, i, i] \
            + [p] * 3 + [i, p]
        lib.bilinear_bwd_movie.argtypes = [p] * 5 + [i, i, i, p, p]
        lib.bilinear_task_sum.argtypes = [p, p, i, i, p, p]
        for f in (lib.bilinear_fwd, lib.bilinear_bwd_user,
                  lib.bilinear_bwd_movie, lib.bilinear_task_sum):
            f.restype = i
        _lib = lib
    return _lib


def _check(err: int, what: str):
    if err == -1:
        raise ValueError(f"bilinear decoder kernel {what}: unsupported "
                         f"shape (R, B) must be one of {SHAPES}, D <= 128")
    if err != 0:
        raise RuntimeError(f"bilinear decoder {what} launch failed: CUDA "
                           f"error {err}")


def _check_inputs(up, v, a, layout):
    dev = up.device
    for name, x in (("up", up), ("v", v), ("a", a)):
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"bilinear decoder kernel: {name} must be a "
                             f"contiguous float32 tensor on {dev}")
    if up.shape[0] != layout.n_users or v.shape[0] != layout.n_movies \
            or up.shape[2] != v.shape[1] or a.shape[1] != up.shape[1]:
        raise ValueError("bilinear decoder kernel: shapes do not match the "
                         "layout")
    if (a.shape[0], a.shape[1]) not in SHAPES or v.shape[1] > 128:
        raise ValueError(f"bilinear decoder kernel: (R, B) = "
                         f"{tuple(a.shape)} not one of {SHAPES}, or D > 128")


def launch_fwd(up, v, a, layout: BilinearLayout) -> torch.Tensor:
    """Logits (R, E) f32 of one forward launch; up (n_users, B, D)."""
    _check_inputs(up, v, a, layout)
    r, b = a.shape
    out = torch.empty((r, layout.n_edges), dtype=torch.float32,
                      device=up.device)
    _check(_load().bilinear_fwd(
        up.data_ptr(), v.data_ptr(), a.data_ptr(), layout.src.data_ptr(),
        layout.dst.data_ptr(), out.data_ptr(), layout.n_edges, v.shape[1],
        r, b, stream_ptr(up.device)), "forward")
    LAUNCHES["fwd"] += 1
    return out


def _task_sum(part, tptr, n_nodes: int, width: int, dev) -> torch.Tensor:
    out = torch.empty((n_nodes, width), dtype=torch.float32, device=dev)
    _check(_load().bilinear_task_sum(part.data_ptr(), tptr.data_ptr(),
                                     n_nodes, width, out.data_ptr(),
                                     stream_ptr(dev)), "task sum")
    return out


def launch_bwd(g, up, u, v, a, layout: BilinearLayout):
    """The two passes and their task sums: (dUP (n_users, B, D), da (R, B),
    W (n_movies, B, D)) of the cotangent g (R, E)."""
    _check_inputs(up, v, a, layout)
    lib, dev = _load(), up.device
    r, b = a.shape
    d, e = v.shape[1], layout.n_edges
    g = g.float().contiguous()
    u = u.contiguous()
    n_ut = layout.u_task_node.shape[0]
    n_mt = layout.m_task_beg.shape[0] - 1
    warps = min(USER_WARPS, max(8, -(-n_ut // 8) * 8))
    part = torch.empty((n_ut, b * d), dtype=torch.float32, device=dev)
    ds = torch.empty((e, b), dtype=torch.float32, device=dev)
    da_part = torch.empty((warps, r * b), dtype=torch.float32, device=dev)
    _check(lib.bilinear_bwd_user(
        g.data_ptr(), up.data_ptr(), v.data_ptr(), a.data_ptr(),
        layout.dst.data_ptr(), layout.u_task_node.data_ptr(),
        layout.u_task_beg.data_ptr(), n_ut, e, d, r, b, part.data_ptr(),
        ds.data_ptr(), da_part.data_ptr(), warps, stream_ptr(dev)),
        "user pass")
    dup = _task_sum(part, layout.u_tptr, layout.n_users, b * d, dev)
    del part
    part = torch.empty((n_mt, b * d), dtype=torch.float32, device=dev)
    _check(lib.bilinear_bwd_movie(
        ds.data_ptr(), u.data_ptr(), layout.perm.data_ptr(),
        layout.m_src.data_ptr(), layout.m_task_beg.data_ptr(), n_mt, d, b,
        part.data_ptr(), stream_ptr(dev)), "movie pass")
    w = _task_sum(part, layout.m_tptr, layout.n_movies, b * d, dev)
    da = da_part.sum(0).reshape(r, b)
    LAUNCHES["bwd"] += 1
    return dup.reshape(-1, b, d), da, w.reshape(-1, b, d)


# ---------------------------------------------------------------------------
# The differentiable decoder.

class _Bilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, p, a, layout):
        b, d = p.shape[0], p.shape[1]
        up = (u @ basis_cat(p)).reshape(-1, b, d)
        with span("bilinear"):
            if up.is_cuda:
                out = launch_fwd(up, v.contiguous(), a.contiguous(), layout)
            else:
                out = bilinear_fwd_plain(up, v, a, layout)
        ctx.save_for_backward(u, v, p, a, up)
        ctx.layout = layout
        return out

    @staticmethod
    def backward(ctx, g):
        with span("decoder_bwd"):
            u, v, p, a, up = ctx.saved_tensors
            layout = ctx.layout
            with span("bilinear_bwd"):
                if g.is_cuda:
                    dup, da, w = launch_bwd(g, up, u, v.contiguous(),
                                            a.contiguous(), layout)
                else:
                    dup, da, w = bilinear_bwd_plain(g, up, u, v, a, layout)
            b, d = p.shape[0], p.shape[1]
            dup = dup.reshape(-1, b * d)
            pcat = basis_cat(p)
            du = dup @ pcat.T
            dp = (u.T @ dup).reshape(d, b, d).permute(1, 0, 2)
            dv = w.reshape(-1, b * d) @ p.reshape(b * d, d)
            return du, dv, dp, da, None


def bilinear_decoder(u, v, p, a, layout: BilinearLayout) -> torch.Tensor:
    """Logits (R, E) in ``layout``'s slot order of the ratings' users' rows
    of u (n_users, D) and movies' rows of v (n_movies, D), with the basis
    p (B, D, D) and the combination a (R, B); all float32."""
    return _Bilinear.apply(u, v, p, a, layout)
