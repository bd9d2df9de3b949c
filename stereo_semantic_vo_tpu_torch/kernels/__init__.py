"""Hand-written CUDA kernels for sm_90a (``csrc/``), each beside its plain
PyTorch version, which a CPU tensor takes."""


def launch_counters() -> dict:
    """Each kernel's counted entry by name: ``entry.launches`` is how often
    it has launched its CUDA kernel in this process (B1, B4 and B6 count on
    the batched entries the one-shot ones call).  A CUDA graph of the step
    (core/cuda_graph.py) adds the launches it captured on every replay."""
    from stereo_semantic_vo_tpu_torch.kernels.ba_hessian import local_ba_blocks, motion_hessian_gradient
    from stereo_semantic_vo_tpu_torch.kernels.cost_volume import cost_volumes
    from stereo_semantic_vo_tpu_torch.kernels.fast_score import fast_scores_levels
    from stereo_semantic_vo_tpu_torch.kernels.hamming import hamming_distance_matrix_pallas
    from stereo_semantic_vo_tpu_torch.kernels.matcher import fused_best_match
    from stereo_semantic_vo_tpu_torch.kernels.patch_extract import extract_patches_levels
    from stereo_semantic_vo_tpu_torch.kernels.sgm_scan import sgm_aggregate_batch
    from stereo_semantic_vo_tpu_torch.kernels.sparse_stereo import keypoint_stereo_costs

    return {"extract_patches": extract_patches_levels, "keypoint_stereo_costs": keypoint_stereo_costs,
            "fused_best_match": fused_best_match, "fast_scores": fast_scores_levels,
            "motion_hessian_gradient": motion_hessian_gradient, "sgm_aggregate": sgm_aggregate_batch,
            "local_ba_blocks": local_ba_blocks, "hamming_distance_matrix_pallas": hamming_distance_matrix_pallas,
            "cost_volumes": cost_volumes}
