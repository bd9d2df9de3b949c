"""PyTorch port, core: config, Lie groups, camera, precision and interop
against the JAX package on the same numpy inputs.

Tolerance for the float functions: rtol 1e-5 (atol 1e-6 for entries near
zero), float32 rounding of the same formulas in another order."""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_semantic_vo_tpu.core import camera as JCam
from stereo_semantic_vo_tpu.core import config as JC
from stereo_semantic_vo_tpu.core import lie as JL
from stereo_semantic_vo_tpu.engine.state import init_state as j_init_state
from stereo_semantic_vo_tpu_torch import interop
from stereo_semantic_vo_tpu_torch.core import camera as TCam
from stereo_semantic_vo_tpu_torch.core import config as TC
from stereo_semantic_vo_tpu_torch.core import lie as TL
from stereo_semantic_vo_tpu_torch.core.precision import f32_geometry, f32_matmul
from stereo_semantic_vo_tpu_torch.engine.state import init_state as t_init_state
from tests.torch_parity import n, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "stereo_semantic_vo_tpu_torch")
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("seq", ["00", "05"])
def test_kitti_config_asdict_equal(seq):
    assert dataclasses.asdict(JC.VOConfig.kitti(seq)) == dataclasses.asdict(TC.VOConfig.kitti(seq))


def test_dense_local_ba_config_round_trip():
    """Every dense-stereo and window-BA knob crosses from the JAX package
    (a knob the port dropped would make the dicts differ)."""
    k = JC.VOConfig.kitti("00")
    cfg = dataclasses.replace(
        k,
        stereo=dataclasses.replace(k.stereo, sparse_mode="dense", dense_backend="xla", edge_p2_gamma=7.0,
                                   refine=False, lr_consistency_px=2.0),
        ba=dataclasses.replace(k.ba, local_hessian_backend="pallas", local_iterations=3, max_landmarks=1024),
        window=JC.WindowConfig(window_frames=6, max_map_points=3072),
    )
    assert dataclasses.asdict(interop.config_from_jax(cfg)) == dataclasses.asdict(cfg)


def test_default_config_equal_and_converted():
    assert dataclasses.asdict(JC.VOConfig()) == dataclasses.asdict(TC.VOConfig())
    assert interop.config_from_jax(JC.VOConfig.kitti("07")) == TC.VOConfig.kitti("07")


def test_resolve_backend_by_device():
    assert TC.resolve_backend("auto", "cpu", "pallas", "strips") == "strips"
    assert TC.resolve_backend("auto", torch.device("cuda", 0), "pallas", "strips") == "pallas"
    assert TC.resolve_backend("strips", "cuda", "pallas", "volume") == "strips"
    assert TC.MatcherConfig(backend="auto").resolved_backend("cpu") == "popcount"
    assert TC.MatcherConfig(backend="auto").resolved_backend("cuda") == "pallas"
    assert TC.MatcherConfig(backend="mxu").resolved_backend("cuda") == "popcount"


def _rot_inputs():
    rng = np.random.RandomState(0)
    phi = rng.normal(0, 0.8, (16, 3)).astype(np.float32)
    phi[0] = 0.0
    phi[1] = [1e-5, -2e-5, 0.0]
    phi[2] = [3.1, 0.0, 0.0]        # near pi
    phi[3] = [0.0, 0.0, -3.05]
    return phi


def _se3_inputs():
    rng = np.random.RandomState(1)
    xi = np.concatenate([rng.normal(0, 2, (16, 3)), _rot_inputs()], axis=1).astype(np.float32)
    return xi


def _quat_rotations():
    # one rotation per Shepperd branch: trace > 0, then |x|, |y|, |z| largest
    phis = np.array([[0.1, 0.2, -0.1], [3.0, 0.1, 0.0], [0.0, 3.0, 0.2], [0.1, 0.0, 3.0]], np.float32)
    return [np.asarray(JL.so3_exp(jnp.asarray(p))) for p in phis]


def _lie_case(name):
    """-> (args as numpy, jax fn, torch fn)."""
    phi, xi = _rot_inputs(), _se3_inputs()
    R = np.asarray(JL.so3_exp(jnp.asarray(phi)))
    T = np.asarray(JL.se3_exp(jnp.asarray(xi)))
    pts = np.random.RandomState(2).normal(0, 10, (50, 3)).astype(np.float32)
    args = {
        "hat": (phi,), "vee": (np.asarray(JL.hat(jnp.asarray(phi))),), "so3_exp": (phi,),
        "so3_log": (R,), "_so3_left_jacobian": (phi,), "se3_exp": (xi,), "se3_log": (T,),
        "rt_to_T": (R, xi[:, :3]), "T_inv": (T,), "transform_points": (T[5], pts),
        "quaternion_to_rotation": (np.array([0.1, -0.3, 0.2, 0.9], np.float32),),
    }[name]
    return args, getattr(JL, name), getattr(TL, name)


@pytest.mark.parametrize(
    "name",
    ["hat", "vee", "so3_exp", "so3_log", "_so3_left_jacobian", "se3_exp", "se3_log",
     "rt_to_T", "T_inv", "transform_points", "quaternion_to_rotation"],
)
def test_lie_matches_jax(name):
    args, jf, tf = _lie_case(name)
    want = n(jf(*(jnp.asarray(a) for a in args)))
    got = n(tf(*(t(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL if name != "se3_log" else 1e-5)


@pytest.mark.parametrize("branch", [0, 1, 2, 3])
def test_rotation_to_quaternion_each_branch(branch):
    R = _quat_rotations()[branch]
    np.testing.assert_allclose(
        n(TL.rotation_to_quaternion(t(R))), n(JL.rotation_to_quaternion(jnp.asarray(R))),
        rtol=RTOL, atol=ATOL,
    )


def test_camera_matches_jax():
    cc = JC.CameraConfig()
    jc, tc = JCam.Camera.from_config(cc), TCam.Camera.from_config(TC.CameraConfig(), "cpu")
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.uniform(-5, 5, (40, 2)), rng.uniform(-1, 40, (40, 1))], 1).astype(np.float32)
    pts[0, 2] = 0.0  # guarded depth
    uv = rng.uniform(0, 1241, (40, 2)).astype(np.float32)
    disp = rng.uniform(-1, 48, 40).astype(np.float32)
    for jr, tr in zip(JCam.project(jc, jnp.asarray(pts)), TCam.project(tc, t(pts))):
        np.testing.assert_allclose(n(tr), n(jr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        n(TCam.backproject(tc, t(uv), t(pts[:, 2]))),
        n(JCam.backproject(jc, jnp.asarray(uv), jnp.asarray(pts[:, 2]))), rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_array_equal(
        n(TCam.disparity_to_depth(tc, t(disp))), n(JCam.disparity_to_depth(jc, jnp.asarray(disp)))
    )
    np.testing.assert_array_equal(
        n(TCam.right_keypoint_x(t(uv), t(disp))), n(JCam.right_keypoint_x(jnp.asarray(uv), jnp.asarray(disp)))
    )
    np.testing.assert_array_equal(n(tc.K), n(jc.K))


def test_f32_geometry_disables_tf32_and_restores():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with f32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
        seen = f32_geometry(lambda: torch.get_float32_matmul_precision())()
        assert seen == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def test_state_interop_round_trip():
    cfg = JC.VOConfig(orb=JC.ORBConfig(max_keypoints=64))
    arrays = {k: np.asarray(v) for k, v in j_init_state(cfg)._asdict().items()}
    st = interop.state_from_numpy(arrays, "cpu")
    assert st.last_desc.dtype == torch.int32
    assert st.frame_idx.dtype == torch.int32 and st.frame_idx.shape == () and int(st.frame_idx) == -1
    back = interop.state_to_numpy(st)
    assert set(arrays) - set(back) == {"last_desc_pm1", "map_desc_pm1"}
    for k, v in back.items():
        assert v.dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    fresh = interop.state_to_numpy(t_init_state(interop.config_from_jax(cfg), "cpu"))
    for k, v in fresh.items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)


def _py_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_port_source_imports_no_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|stereo_semantic_vo_tpu)\b(?!_torch)", re.M)
    offenders = [p for p in _py_files() if bad.search(open(p).read())]
    assert not offenders, offenders


def test_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import stereo_semantic_vo_tpu_torch.run, stereo_semantic_vo_tpu_torch.interop\n"
        "import stereo_semantic_vo_tpu_torch.engine.pipeline, stereo_semantic_vo_tpu_torch.eval.ate\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'stereo_semantic_vo_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
