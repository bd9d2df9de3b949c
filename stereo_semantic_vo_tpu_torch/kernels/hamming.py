"""Bulk 256-bit Hamming distances and the masked best/second-best reduction.

Port of ``stereo_semantic_vo_tpu.kernels.hamming``.  Descriptors are (N, 8)
int32 tensors holding the bit patterns of the JAX package's uint32 words
(PyTorch has little uint32 support); only bits matter here, so the sign of
a word is irrelevant.

``hamming_distance_matrix_pallas`` is the full (Q, T) distance-matrix
kernel, ``csrc/hamming.cu``, with ``hamming_distance_matrix`` its plain
version; the two are equal.  No tracking path calls it (the matcher fuses
the reduction, ``kernels/matcher.py``), as in the reference, where only its
tests and kernel benchmark do.

Dropped: ``unpack_descriptors_pm1`` and ``hamming_distance_matrix_mxu``
(the +-1 int8 matmul form exists for the TPU's matrix unit), together with
the state's ``last_desc_pm1`` / ``map_desc_pm1`` that fed it.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.kernels import build

DESC_WORDS = 8  # 256 bits as 8 x 32-bit words
DESC_BITS = 256


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word (SWAR; the masks clear the sign bits
    that arithmetic right shifts bring in)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_distance_matrix(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(Q, 8) x (T, 8) int32 -> (Q, T) int32 Hamming distances, one
    descriptor word at a time so no (Q, T, 8) temporary is built."""
    d = torch.zeros((query.shape[0], train.shape[0]), dtype=torch.int32, device=query.device)
    for w in range(query.shape[1]):
        d += popcount32(torch.bitwise_xor(query[:, w, None], train[None, :, w]))
    return d


def hamming_distance_matrix_pallas(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(Q, 8) x (T, 8) int32 -> (Q, T) int32 Hamming distances.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which reads 16-byte words: both must start on a 16-byte boundary."""
    if query.device.type == "cpu":
        return hamming_distance_matrix(query, train)
    Q, T = query.shape[0], train.shape[0]
    index = query.get_device()
    build.check_tensors(index, (("query", query, torch.int32, (Q, DESC_WORDS)),
                                ("train", train, torch.int32, (T, DESC_WORDS))))
    if (query.data_ptr() | train.data_ptr()) % 16:
        raise ValueError("query and train must start on a 16-byte boundary (the kernel reads 16-byte words)")
    out = torch.empty((Q, T), dtype=torch.int32, device=query.device)
    build.call_on(index, "ssvo_hamming_distance_matrix", query.data_ptr(), train.data_ptr(), Q, T, out.data_ptr(),
                  build.stream_handle(query))
    hamming_distance_matrix_pallas.launches += 1
    return out


hamming_distance_matrix_pallas.launches = 0


def masked_best_match(
    dist: torch.Tensor,
    query_valid: torch.Tensor,
    train_valid: torch.Tensor,
    big: int = DESC_BITS + 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise best and second-best over a masked distance matrix.

    Returns (best_idx, best_dist, second_dist), each (Q,) int32; masked
    pairs count as ``big``; ties go to the lower train index (argmin returns
    the first minimum, as ``jnp.argmin`` does)."""
    valid = query_valid[:, None] & train_valid[None, :]
    d = torch.where(valid, dist, big).to(torch.int32)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], big)
    second = torch.amin(d2, dim=1)
    return best_idx.to(torch.int32), best, second
