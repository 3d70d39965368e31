"""The ported slice end to end, against the JAX package, on the CPU: one
``tiny`` synthetic frame through ``ChunkedRenderer`` prepare + render, the
bridge's state-dict keys against the reference export, and the port's
drivers (the eval, train and vis ones) running without JAX in a
subprocess."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs.experiments import get_config
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils.ref_export import export_reference_state_dict
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import eval_lib as teval
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import jit_apply, memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("depth", "rgb", "acc", "sem")


def _noisy(tree, rng, scale=0.1):
    """numpy copy of a flax param tree with noise on every leaf (kernels
    scaled by 1/sqrt(fan_in)), inv_s left at its init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng, scale)
            continue
        v = np.asarray(v, np.float32)
        noise = np.asarray(rng.randn(*v.shape), np.float32)
        if k == "kernel":
            noise = noise / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = v if k == "variance" else v + scale * noise
    return out


@pytest.fixture(scope="module")
def tiny_frame():
    cfg = get_config("tiny")
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size,
                          num_classes=max(cfg.num_classes,
                                          cfg.model.head.sem_dims),
                          length=1)
    batch = {k: np.asarray(v) for k, v in ds[0].items()
             if not isinstance(v, (str, dict))}
    jmodel = JSegmentor(cfg=cfg.model)
    variables = jeval.init_variables(
        jmodel, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np_params = _noisy(jax.tree_util.tree_map(np.asarray,
                                              variables["params"]),
                       np.random.RandomState(0))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, np_params),
                 "consts": variables["consts"]}
    return cfg, batch, jmodel, variables, np_params


def test_tiny_frame_matches_jax(tiny_frame):
    cfg, batch, jmodel, variables, np_params = tiny_frame
    jr = jeval.ChunkedRenderer(jmodel, variables, chunk=96, shard=False,
                               volume_dtype="float32", outputs=OUTPUTS)
    jvol = jr.prepare(jnp.asarray(batch["imgs"]),
                      jnp.asarray(batch["lidar2img"]))
    jo, jd = jeval.rays_for_cams(jeval.eval_trans_mats(batch, cfg),
                                 jeval.eval_ray_grid(cfg))
    ref = jr.render(jvol, jo, jd)

    tmodel = TPVSegmentor(cfg.model).eval()
    tmodel.load_state_dict(from_jax_variables({"params": np_params}),
                           strict=True)
    tr = teval.ChunkedRenderer(tmodel, chunk=96, outputs=OUTPUTS)
    tvol = tr.prepare(torch.from_numpy(batch["imgs"]),
                      torch.from_numpy(batch["lidar2img"]))
    # encoder + decode, fp32 with sums in another order: atol 1e-4
    np.testing.assert_allclose(tvol.numpy(), np.asarray(jvol), atol=1e-4,
                               rtol=1e-4)
    to, td = teval.rays_for_cams(
        torch.from_numpy(teval.eval_trans_mats(batch, cfg)),
        teval.eval_ray_grid(cfg))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    got = tr.render(tvol, to, td)
    rh, rw = cfg.eval_num_rays
    assert set(got) == set(ref) == set(OUTPUTS)
    assert got["depth"].shape == (cfg.num_cams * rh * rw,)
    # the rendered outputs inherit the volume's 1e-4 and go through the
    # same fp32 formulas: depth rtol 1e-4, composites atol 1e-4
    np.testing.assert_allclose(got["depth"], ref["depth"], rtol=1e-4,
                               atol=1e-5)
    for k in ("rgb", "acc", "sem"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)
    assert np.isfinite(got["depth"]).all()


def test_eval_forward_returns_vis_normal_and_second_grad(tiny_frame):
    # the head's forward with train=False returns what the JAX head's
    # __call__(train=False) returns (selfocc_tpu/models/heads.py:491-496),
    # normal_vis and second_grad included, for the fixed eval ray grid
    cfg, batch, jmodel, variables, np_params = tiny_frame
    kw = cfg.model.head.trans_kw
    ref = jit_apply(jmodel, variables, jnp.asarray(batch["imgs"]),
                    jnp.asarray(batch["lidar2img"]), jnp.asarray(batch[kw]),
                    train=False)
    tmodel = TPVSegmentor(cfg.model).eval()
    tmodel.load_state_dict(from_jax_variables({"params": np_params}),
                           strict=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(batch["imgs"]),
                     torch.from_numpy(batch["lidar2img"]),
                     torch.from_numpy(batch[kw]), train=False)
    assert {"vis_normal", "second_grad"} <= set(got)
    assert set(got) == set(ref)
    # composites of the volume's 1e-4 (test_tiny_frame_matches_jax): 1e-4
    np.testing.assert_allclose(got["vis_normal"][0].numpy(),
                               np.asarray(ref["vis_normal"][0]), atol=1e-4)
    np.testing.assert_allclose(got["ms_depths"][0].numpy(),
                               np.asarray(ref["ms_depths"][0]), rtol=1e-4,
                               atol=1e-5)
    # central differences of the sdf gradient: the tolerance of
    # tests/test_torch_port_train.py::test_second_grad_matches_jax
    sg_ref = np.asarray(ref["second_grad"])
    np.testing.assert_allclose(got["second_grad"].numpy(), sg_ref,
                               atol=1e-4 * float(np.abs(sg_ref).max()) + 1e-5)


def test_bridge_keys_match_reference_export():
    # ResNet-50 + FPN + encoder + field: the bridged keys are the reference
    # checkpoint's (``ref_export``), and the port loads them strictly
    cfg = get_config("tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_type="resnet50",
        fpn_in_channels=(256, 512, 1024, 2048)))
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size, num_classes=5, length=1)
    b = {k: jnp.asarray(v) for k, v in ds[0].items()}
    jmodel = JSegmentor(cfg=cfg.model)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, b["imgs"], b["lidar2img"],
        b["temImg2lidar"], key, 0, True))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   {k: v for k, v in shapes.items()
                                    if k != "consts"})
    sd = from_jax_variables(zeros)
    exported = export_reference_state_dict(zeros, as_torch=False)
    assert set(sd) == set(exported)
    for k, v in exported.items():
        assert tuple(sd[k].shape) == tuple(np.shape(v)), k
    tmodel = TPVSegmentor(cfg.model)
    assert set(tmodel.state_dict()) == set(sd)
    tmodel.load_state_dict(sd, strict=True)


def test_eval_depth_runs_without_jax(tmp_path):
    # the drivers' main on tiny, on the CPU, in a fresh process: nothing of
    # JAX and nothing of the JAX package (top-level name ``selfocc_tpu``)
    # may be imported
    code = (
        "import sys\n"
        "from selfocc_tpu_torch import eval_depth, eval_iou, "
        "eval_iou_kitti, eval_novel_depth, eval_novel_depth_kitti, train\n"
        "from selfocc_tpu_torch.data import (build_dataset, kitti_dataset,"
        " kitti_eval_dataset, kitti_raw_dataset, nuscenes_dataset,"
        " nuscenes_eval_dataset, prefetch, sampler, semantic_kitti_io,"
        " transforms, wrapper)\n"
        "from selfocc_tpu_torch.losses import EdgeLoss3DMS\n"
        "from selfocc_tpu_torch.native import get_shared_loader\n"
        "from selfocc_tpu_torch.utils import (checkpoint, effnet_import,"
        " logging_util, openseed_utils, scenerf_metric, swin_import)\n"
        "from selfocc_tpu_torch.geometry.mappings import NonLinearMapping\n"
        "from selfocc_tpu_torch.models import (efficientnet, swin, unet2d,"
        " upernet)\n"
        "from selfocc_tpu_torch.models.fpn import IdentityNeck\n"
        "from selfocc_tpu_torch.models.encoder import CameraAwareSE\n"
        "from selfocc_tpu_torch.models.heads import FlowNet\n"
        "from selfocc_tpu_torch.models.lifter import TPVPositionLifter\n"
        "from selfocc_tpu_torch import (examine_sweeps, generate_videos,"
        " vis_3d, vis_3d_scene, vis_pics)\n"
        "from selfocc_tpu_torch.data import vis_dataset\n"
        "from selfocc_tpu_torch.utils import magma, temporal_pkl\n"
        "eval_depth.main(['--py-config', 'tiny', '--synthetic',"
        " '--num-samples', '1', '--batch', '256', '--device', 'cpu'])\n"
        "eval_depth.main(['--py-config', 'tiny', '--synthetic',"
        " '--num-samples', '1', '--batch', '256', '--flip',"
        " '--depth-metric-tgt', 'max', '--device', 'cpu'])\n"
        "eval_iou.main(['--py-config', 'tiny', '--synthetic',"
        " '--num-samples', '1', '--resolution', '1.0', '--occ3d',"
        " '--use-mask', '--sem', '--device', 'cpu'])\n"
        "train.main(['--py-config', 'tiny', '--synthetic', '--max-steps',"
        f" '1', '--device', 'cpu', '--work-dir', {str(tmp_path)!r}])\n"
        "eval_novel_depth.main(['--py-config', 'tiny', '--synthetic',"
        " '--num-samples', '1', '--batch', '256', '--depth-tgt', 'max',"
        " '--device', 'cpu'])\n"
        "eval_iou_kitti.main(['--py-config', 'tiny', '--synthetic',"
        " '--num-samples', '1', '--resolution', '1.0', '--sem',"
        " '--device', 'cpu'])\n"
        "eval_novel_depth_kitti.main(['--py-config', 'tiny', '--synthetic',"
        " '--num-samples', '1', '--batch', '256', '--offsets', '1.1',"
        " '--device', 'cpu'])\n"
        "vis_pics.main(['--py-config', 'tiny', '--synthetic',"
        " '--num-samples', '1', '--batch', '256', '--novel-view', '1.0123',"
        " '0.5', '0.3', '10', '--device', 'cpu', '--work-dir',"
        f" {str(tmp_path / 'vis')!r}])\n"
        "vis_3d.main(['--py-config', 'tiny', '--synthetic', '--num-samples',"
        " '1', '--resolution', '1.0', '--gt', '--device', 'cpu',"
        f" '--work-dir', {str(tmp_path / 'vis3d')!r}])\n"
        "vis_3d_scene.main(['--py-config', 'tiny', '--synthetic',"
        " '--num-samples', '2', '--resolution', '1.0', '--device', 'cpu',"
        f" '--work-dir', {str(tmp_path / 'scene')!r}])\n"
        "generate_videos.main(['--src-dir',"
        f" {str(tmp_path / 'vis')!r}, '--out',"
        f" {str(tmp_path / 'demo.mp4')!r}, '--num-cams', '2'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'selfocc_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert "rendered 192 rays" in proc.stdout
    assert "raw evaluation:" in proc.stdout
    assert "miou_miou:" in proc.stdout
    assert "checkpoint saved" in proc.stdout
    assert "rendered 4 novel views" in proc.stdout
    assert "SceneRF iou:" in proc.stdout and "mIoU:" in proc.stdout
    assert "rendered 1 novel views" in proc.stdout
    assert "[0] wrote 2 depth/rgb maps" in proc.stdout
    assert "GT voxels exported" in proc.stdout
    assert "scene cloud:" in proc.stdout
    assert "wrote 1 frames to" in proc.stdout


@pytest.mark.parametrize("module", ["eval_depth", "eval_iou", "train",
                                    "eval_novel_depth", "eval_iou_kitti",
                                    "eval_novel_depth_kitti", "vis_pics",
                                    "vis_3d", "vis_3d_scene"])
def test_drivers_need_a_card_or_device_cpu_and_synthetic(module):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", f"selfocc_tpu_torch.{module}",
            "--py-config", "tiny", "--max-steps" if module == "train"
            else "--num-samples", "1"]
    # no card and no --device cpu: a non-zero exit with a message
    proc = subprocess.run(base + ["--synthetic"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
    # no --synthetic: an error, not synthetic data
    proc = subprocess.run(base + ["--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "real-data loaders" in proc.stderr


def test_port_sources_import_nothing_of_the_jax_package():
    pattern = re.compile(r"^\s*(import selfocc_tpu\.|from selfocc_tpu\.|"
                         r"from selfocc_tpu import|import selfocc_tpu\s*$|"
                         r"import jax|from jax)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "selfocc_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    assert os.path.join(REPO, "selfocc_tpu_torch", "native",
                        "__init__.py") in files
    bad = []
    for path in files:
        with open(path) as f:
            bad += [f"{path}: {m.group(0).strip()}"
                    for m in pattern.finditer(f.read())]
    assert not bad, bad
