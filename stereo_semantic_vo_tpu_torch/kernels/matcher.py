"""Fused Hamming matcher: distances plus best/second-best in one CUDA kernel.

Port of ``stereo_semantic_vo_tpu.kernels.matcher.fused_best_match``; the
kernel is ``csrc/matcher.cu`` (a lane a strided slice of the train set,
the lanes' best and second-best codes merged by shuffles).  The plain
version is ``masked_best_match`` over ``hamming_distance_matrix``: same
outputs, idx included.
"""

from __future__ import annotations

import torch

from stereo_semantic_vo_tpu_torch.kernels import build
from stereo_semantic_vo_tpu_torch.kernels.hamming import (
    DESC_WORDS,
    hamming_distance_matrix,
    masked_best_match,
)

def fused_best_match_plain(
    query: torch.Tensor, train: torch.Tensor, query_valid: torch.Tensor, train_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return masked_best_match(hamming_distance_matrix(query, train), query_valid, train_valid)


def fused_best_match(
    query: torch.Tensor, train: torch.Tensor, query_valid: torch.Tensor, train_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Q, 8) x (T, 8) int32 descriptors, (Q,) / (T,) bool masks ->
    (best_idx, best, second), each (Q,) int32; masked pairs have distance 257.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    the three outputs are views of one (3, Q) int32 buffer."""
    if query.device.type == "cpu":
        return fused_best_match_plain(query, train, query_valid, train_valid)
    Q, T = query.shape[0], train.shape[0]
    index = query.get_device()
    build.check_tensors(index, (("query", query, torch.int32, (Q, DESC_WORDS)),
                                ("train", train, torch.int32, (T, DESC_WORDS)),
                                ("query_valid", query_valid, torch.bool, (Q,)),
                                ("train_valid", train_valid, torch.bool, (T,))))
    if T < 1 or (T + 1) * (DESC_WORDS * 32 + 1) >= 2**31:
        raise ValueError(f"train size {T} out of range")
    if (query.data_ptr() | train.data_ptr()) % 16:
        raise ValueError("query and train must start on a 16-byte boundary (the kernel reads 16-byte words)")
    out = torch.empty((3, Q), dtype=torch.int32, device=query.device)
    build.call_on(index, "ssvo_fused_best_match", query.data_ptr(), train.data_ptr(), query_valid.data_ptr(),
                  train_valid.data_ptr(), Q, T, out.data_ptr(), build.stream_handle(query))
    fused_best_match.launches += 1
    return out.unbind(0)


fused_best_match.launches = 0
