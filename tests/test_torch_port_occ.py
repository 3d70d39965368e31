"""The occupancy slice of the port against the JAX package on the CPU, at
``tiny``: the field's occupancy queries, the head's uniform-grid sdf, the
``GridOccEvaluator`` queries (gather and separable, Occ3D), the grid axes,
the ``eval_iou`` drivers' IoU tables, and the weights flags
(``--ckpt-path``, ``--torch-ckpt``) of ``eval_iou`` and ``eval_depth``.

Both packages get the same weights: the JAX init the JAX ``eval_iou``
driver makes (seed 42) with numpy noise on every leaf but the backbone's
(the reference export has no tiny backbone, so the JAX driver keeps its
own). The two packages' grid axes differ by up to 1 ulp of the axis's
larger endpoint (``jnp.linspace`` in fp32 against the port's
float64-then-rounded axes), so where occupancy or classes are compared, a
voxel may differ only where such a shift can flip it: |sdf| < 1e-5, or a
logit gap < 1e-5.
"""
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import eval_iou as jdriver
from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu.utils import metrics as jmetrics
from selfocc_tpu.utils.ref_export import export_reference_state_dict
from selfocc_tpu_torch import eval_depth, eval_iou, train
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models.heads import uniform_axes
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import eval_lib as teval
from selfocc_tpu_torch.utils.runtime import get_logger, load_weights
from test_torch_port_slice import _noisy
from test_torch_port_threads import share_cores_with_xdist_workers
from torch_port_jax import memoised_jax_init  # noqa: F401

share_cores_with_xdist_workers()

T = torch.from_numpy
FLIP = 1e-5          # |sdf| or logit gap below which 1 ulp may flip a voxel
OCC3D_PCR, OCC3D_EXP = jdriver.OCC3D_SCENES[4]


def _ego2lidar():
    theta = 0.1
    m = np.eye(4)
    m[:2, :2] = [[np.cos(theta), -np.sin(theta)],
                 [np.sin(theta), np.cos(theta)]]
    m[:3, 3] = [1.5, -2.0, 0.3]
    return m


@pytest.fixture(scope="module")
def occ():
    """JAX model + variables, the bridged port model, one prepared volume
    (JAX's, handed to the port in the decode's channel-last layout)."""
    cfg = jget_config("tiny")
    ds = SyntheticDataset(num_cams=cfg.num_cams, input_size=cfg.input_size,
                          img_size=cfg.img_size,
                          num_classes=max(cfg.num_classes,
                                          cfg.model.head.sem_dims),
                          length=1)
    batch = {k: np.asarray(v) for k, v in ds[0].items()
             if not isinstance(v, (str, dict))}
    jmodel = JSegmentor(cfg=cfg.model)
    init = jeval.init_variables(
        jmodel, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, 42)
    params = jax.tree_util.tree_map(np.asarray, init["params"])
    params = dict(_noisy({k: v for k, v in params.items()
                          if k != "img_backbone"}, np.random.RandomState(5)),
                  img_backbone=params["img_backbone"])
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "consts": init["consts"]}
    tmodel = TPVSegmentor(get_config("tiny").model).eval()
    tmodel.load_state_dict(from_jax_variables({"params": params}),
                           strict=True)
    jvol = np.asarray(jeval.GridOccEvaluator(jmodel, jvars, shard=False)
                      .prepare(jnp.asarray(batch["imgs"]),
                               jnp.asarray(batch["lidar2img"])))
    tvol = T(np.ascontiguousarray(np.moveaxis(jvol, 0, -1))).permute(
        3, 0, 1, 2)
    return dict(cfg=cfg, batch=batch, jmodel=jmodel, jvars=jvars,
                params=params, tmodel=tmodel, jvol=jvol, tvol=tvol)


def _close(got, ref, what):
    """fp32 agreement: within 1e-5 of the reference's largest magnitude
    (the same interpolant; sums in another order, or points 1 ulp apart)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _gap(logits):
    """The gap between the two largest logits of each voxel."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return top[..., -1] - top[..., -2] if top.shape[-1] > 1 else \
        np.full(top.shape[:-1], np.inf)


def _flips(got, ref, may_flip, what):
    """Count the voxels where ``got`` and ``ref`` differ; each must be one
    that ``may_flip`` allows."""
    diff = np.asarray(got) != np.asarray(ref)
    bad = diff & ~may_flip
    print(f"{what}: {int(diff.sum())} of {diff.size} voxels differ")
    assert not bad.any(), (what, int(bad.sum()))
    return int(diff.sum())


def test_query_geo_matches_jax(occ):
    # sdf / SH coefficients / sem logits at points in and around the volume
    rng = np.random.RandomState(0)
    lo = np.array([-12.0, -12.0, -2.0], np.float32)
    hi = np.array([12.0, 12.0, 4.0], np.float32)
    xyz = (lo + rng.rand(40, 50, 3) * (hi - lo)).astype(np.float32)
    ref = occ["jmodel"].apply(
        occ["jvars"], jnp.asarray(occ["jvol"]), jnp.asarray(xyz),
        method=lambda m, v, x: m.head.field.query_geo(v, x))
    got = occ["tmodel"].head.field.query_geo(occ["tvol"], T(xyz))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k].numpy(), ref[k], k)


def test_occ_queries_match_jax_on_the_jax_grid(occ):
    # occ_from_volume at JAX's own flattened grid points and occ_uniform on
    # JAX's own axes: the same points for both, so fp32 agreement throughout
    aabb, res = tuple(occ["cfg"].model.head.roi_aabb), 1.6
    jev = jeval.GridOccEvaluator(occ["jmodel"], occ["jvars"], shard=False)
    flat, _, _, _ = jev._flat_grid(aabb, res)
    xs, ys, zs = (np.array(a) for a in jev._axes(aabb, res))
    jvol = jnp.asarray(occ["jvol"])
    ref = occ["jmodel"].apply(occ["jvars"], jvol, jnp.asarray(flat),
                              method="occ_from_volume")
    flat = np.array(flat)
    got = occ["tmodel"].occ_from_volume(occ["tvol"], T(flat))
    ref_u = occ["jmodel"].apply(occ["jvars"], jvol, *map(jnp.asarray,
                                                         (xs, ys, zs)),
                                method="occ_uniform")
    got_u = occ["tmodel"].occ_uniform(occ["tvol"], T(xs), T(ys), T(zs))
    for g, r, tag in ((got, ref, "gather"), (got_u, ref_u, "separable")):
        assert set(g) == set(r) == {"sdf", "sem", "logits"}, tag
        _close(g["sdf"].numpy(), r["sdf"], f"{tag} sdf")
        _close(g["logits"].numpy(), r["logits"], f"{tag} logits")
        _flips(g["sem"].numpy(), r["sem"], _gap(r["logits"]) < FLIP,
               f"{tag} sem")
    # the sdf-only query samples the sdf plane and gives the same sdf
    sdf_only = occ["tmodel"].occ_from_volume(occ["tvol"], T(flat),
                                             outputs=("sdf",))
    assert set(sdf_only) == {"sdf"}
    np.testing.assert_array_equal(sdf_only["sdf"].numpy(),
                                  got["sdf"].numpy())


@pytest.mark.parametrize("aabb,res", [
    ((-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), 0.2),   # 512 x 512 x 40 (OpenOcc)
    ((-51.2, -51.2, -4.0, 51.2, 51.2, 4.0), 0.2),   # Occ3D scene 0, d 40
    ((-10.0, -10.0, -1.0, 10.0, 10.0, 3.0), 1.0),   # tiny's AABB
    ((-10.0, -10.0, -1.0, 10.0, 10.0, 3.0), 1.6),
    ((-10.0, -10.0, -1.0, 10.0, 10.0, 3.0), 2.9)],
    ids=["openocc", "occ3d", "tiny", "tiny-1.6", "tiny-2.9"])
def test_grid_axes_within_one_ulp_of_jax(aabb, res):
    # JAX's eager fp32 linspace, start * (1 - t) + stop * t, has no
    # bit-exact twin (its jitted form differs too) and rounds at the scale
    # of its endpoints: near 0 it is off the exact value by up to ~150 ulp
    # of the value itself. The port's float64-then-rounded axes lie within
    # 1 ulp of the larger endpoint of JAX's
    ref = jeval.GridOccEvaluator._axes(None, aabb, res)
    got = uniform_axes(aabb, res)
    for name, g, r in zip("xyz", got, ref):
        r = np.asarray(r)
        assert g.dtype == np.float32 and g.shape == r.shape, name
        ulp = float(np.spacing(np.float32(max(abs(r[0]), abs(r[-1])))))
        diff = np.abs(g.astype(np.float64) - r)
        print(f"{name}s ({r[0]}, {r[-1]}, {r.size}): {int((diff > 0).sum())}"
              f" values differ from JAX's, by at most "
              f"{float(diff.max() / ulp)} ulp of the endpoint")
        assert (diff <= ulp).all(), name


def test_get_uniform_sdf_replays_the_jax_shift(occ):
    aabb, res = tuple(occ["cfg"].model.head.roi_aabb), 1.6
    key = jax.random.PRNGKey(3)
    jvol = jnp.asarray(occ["jvol"])
    sdf, logits, xyz = occ["jmodel"].apply(
        occ["jvars"], jvol,
        method=lambda m, v: m.head.get_uniform_sdf(v, aabb, res,
                                                   shift_rng=key))
    shift = np.array(jax.random.uniform(key, xyz.shape))
    head = occ["tmodel"].head
    t_sdf, t_logits, t_xyz = head.get_uniform_sdf(occ["tvol"], aabb, res,
                                                  shift=T(shift))
    # the points inherit the axes' 1 ulp; the sdf and logits at them fp32
    _close(t_xyz.numpy(), xyz, "xyz")
    _close(t_sdf.numpy(), sdf, "sdf")
    _close(t_logits.numpy(), logits, "sem logits")
    # unshifted, and shifted by a generator's draw: the grid's shape
    plain = head.get_uniform_sdf(occ["tvol"], aabb, res)[2]
    drawn = head.get_uniform_sdf(occ["tvol"], aabb, res,
                                 generator=torch.Generator().manual_seed(0))[2]
    assert plain.shape == drawn.shape == t_xyz.shape
    step = (drawn - plain).numpy()
    assert (step >= 0).all() and (step <= res).all() and step.std() > 0


@pytest.mark.parametrize("query", ["gather", "separable"])
@pytest.mark.parametrize("res", [1.6, 2.9])
def test_grid_occ_evaluator_matches_jax(occ, res, query):
    aabb = tuple(occ["cfg"].model.head.roi_aabb)
    jev = jeval.GridOccEvaluator(occ["jmodel"], occ["jvars"], shard=False,
                                 query=query)
    tev = teval.GridOccEvaluator(occ["tmodel"], query=query)
    jvol = jnp.asarray(occ["jvol"])
    ref = jev.query_grid(jvol, aabb, res)
    got = tev.query_grid(occ["tvol"], aabb, res)
    assert set(got) == set(ref) == {"sdf", "sem", "logits", "xyz"}
    assert got["sem"].dtype == ref["sem"].dtype == np.uint8
    for k in ("xyz", "sdf", "logits"):
        _close(got[k], ref[k], k)
    _flips(got["sem"], ref["sem"], _gap(ref["logits"]) < FLIP,
           f"{query} {res} sem")
    # keys= selects what is returned
    only = tev.query_grid(occ["tvol"], aabb, res, keys=("sdf",))
    assert set(only) == set(jev.query_grid(jvol, aabb, res, keys=("sdf",)))
    _close(only["sdf"], ref["sdf"], "sdf alone")

    # the Occ3D query: the dense sdf / logits resampled at the ego grid
    pts = jdriver.occ3d_ego_to_grid_coords(OCC3D_PCR, OCC3D_EXP,
                                           _ego2lidar())
    ref3 = jev.query_grid_occ3d(jvol, tuple(OCC3D_PCR), res, pts, OCC3D_PCR,
                                OCC3D_EXP)
    got3 = tev.query_grid_occ3d(occ["tvol"], tuple(OCC3D_PCR), res, pts,
                                OCC3D_PCR, OCC3D_EXP)
    assert set(got3) == set(ref3) == {"sdf_r", "sem_r"}
    _close(got3["sdf_r"], ref3["sdf_r"], "sdf_r")
    idx = T(teval.occ3d_indices(pts, OCC3D_PCR, OCC3D_EXP,
                                tev.grid_shape(OCC3D_PCR, res)))
    lr = tev.query_grid_occ3d_device(occ["tvol"], tuple(OCC3D_PCR), res,
                                     idx)["logits_r"].numpy()
    _flips(got3["sem_r"], ref3["sem_r"], _gap(lr) < FLIP,
           f"{query} {res} occ3d sem_r")


def test_forward_occ_matches_jax(occ):
    # the segmentor's forward_occ end to end (prepare in each package, then
    # the uniform grid), and the evaluator's forward_occ on the port
    aabb, res = tuple(occ["cfg"].model.head.roi_aabb), 1.6
    imgs, l2i = occ["batch"]["imgs"], occ["batch"]["lidar2img"]
    ref = jax.jit(lambda v, i, m: occ["jmodel"].apply(
        v, i, m, aabb=aabb, resolution=res, method="forward_occ"))(
        occ["jvars"], jnp.asarray(imgs), jnp.asarray(l2i))
    with torch.no_grad():
        got = occ["tmodel"].forward_occ(T(imgs), T(l2i), aabb, res)
    assert set(got) == set(ref) == {"sdf", "sem", "logits", "xyz"}
    _close(got["xyz"].numpy(), ref["xyz"], "xyz")
    # each package's own volume: the prepare's 1e-4
    # (test_tiny_frame_matches_jax) carries into the sdf and logits, and a
    # class may flip where the top two logits lie within 1e-3
    for k in ("sdf", "logits"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], atol=1e-4,
                                   err_msg=k)
    _flips(got["sem"].numpy(), ref["sem"], _gap(ref["logits"]) < 1e-3,
           "forward_occ sem")
    ev = teval.GridOccEvaluator(occ["tmodel"]).forward_occ(T(imgs), T(l2i),
                                                           aabb, res)
    for k in ("sdf", "logits", "xyz"):
        np.testing.assert_array_equal(ev[k], got[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(ev["sem"], got["sem"].numpy())


def _tiny_pth(params, tmp_path, name, drop=()):
    """The JAX variables as a reference checkpoint (``ref_export``), saved
    as a training run saves one (``state_dict``, ``module.`` prefixes,
    BatchNorm ``num_batches_tracked``), plus the tiny backbone under the
    port's names: the reference has no tiny backbone, so ``ref_export``
    writes none."""
    sd = export_reference_state_dict({"params": params})
    sd.update({k: v for k, v in from_jax_variables({"params": params}).items()
               if k.startswith("img_backbone.")})
    sd = {k: v for k, v in sd.items() if not k.startswith(drop)}
    sd["img_neck.lateral_convs.0.bn.num_batches_tracked"] = torch.tensor(3)
    path = str(tmp_path / name)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "meta": {}}, path)
    return path


def test_eval_iou_driver_matches_jax(occ, tmp_path, monkeypatch):
    # both drivers on the Occ3D path with masks, semantics and saved
    # classes, at the same weights (JAX imports the reference export; the
    # port loads it with the tiny backbone added); the IoU / mIoU tables
    # agree up to voxels a 1-ulp shift of the grid may flip
    flags = ["--py-config", "tiny", "--synthetic", "--num-samples", "1",
             "--resolution", "1.0", "--occ3d", "--use-mask", "--sem"]
    jpth = str(tmp_path / "ref.pth")
    torch.save({"state_dict": export_reference_state_dict(
        {"params": occ["params"]})}, jpth)
    tpth = _tiny_pth(occ["params"], tmp_path, "port.pth")
    seen = {"j": [], "t": [], "jm": []}
    for mod, tag in ((jeval, "j"), (teval, "t")):
        # the port's device form also gives the resampled logits
        name = ("query_grid_occ3d" if tag == "j" else
                "query_grid_occ3d_device")
        orig = getattr(mod.GridOccEvaluator, name)

        def rec(self, *a, _orig=orig, _tag=tag, **kw):
            out = _orig(self, *a, **kw)
            seen[_tag].append({k: np.asarray(v) for k, v in out.items()})
            return out
        monkeypatch.setattr(mod.GridOccEvaluator, name, rec)
    orig_epoch = jmetrics.MeanIoU._after_epoch

    def epoch(self, logger=None):
        seen["jm"].append(self)
        return orig_epoch(self, logger)
    monkeypatch.setattr(jmetrics.MeanIoU, "_after_epoch", epoch)
    monkeypatch.setattr(sys, "argv", ["eval_iou.py", *flags, "--work-dir",
                                      str(tmp_path / "j"), "--torch-ckpt",
                                      jpth, "--save-sem",
                                      str(tmp_path / "jsem")])
    jdriver.main()
    res = eval_iou.main(flags + ["--device", "cpu", "--torch-ckpt", tpth,
                                 "--save-sem", str(tmp_path / "tsem")])

    (j,), (t,) = seen["j"], seen["t"]
    _close(t["sdf_r"], j["sdf_r"], "sdf_r")
    occ_j, occ_t = j["sdf_r"] <= 0.0, t["sdf_r"] <= 0.0
    n_occ = _flips(occ_t, occ_j, (np.abs(j["sdf_r"]) < FLIP)
                   | (np.abs(t["sdf_r"]) < FLIP), "driver occupancy")
    n_sem = _flips(t["sem_r"], j["sem_r"], _gap(t["logits_r"]) < FLIP,
                   "driver sem_r")
    jsem = np.load(next((tmp_path / "jsem").rglob("labels.npz")))
    tsem = np.load(next((tmp_path / "tsem").rglob("labels.npz")))
    assert int((jsem["semantics"] != tsem["semantics"]).sum()) <= \
        n_occ + n_sem
    # the tables: the same counts but for the voxels allowed to flip
    jiou, jmiou = seen["jm"]
    for tm, jm in ((res["iou_metric"], jiou), (res["miou_metric"], jmiou)):
        for k in ("total_seen", "total_correct", "total_positive"):
            assert np.abs(getattr(tm, k) - getattr(jm, k)).max() <= \
                n_occ + n_sem, k
    if n_occ + n_sem == 0:
        assert (res["iou_miou"], res["iou_iou"]) == jiou._after_epoch()
        assert (res["miou_miou"], res["miou_iou"]) == jmiou._after_epoch()


def _jax_depth(occ, ds):
    cfg, item = occ["cfg"], ds[0]
    jr = jeval.ChunkedRenderer(occ["jmodel"], occ["jvars"], chunk=96,
                               shard=False, volume_dtype="float32",
                               outputs=("depth",))
    b = {k: jnp.asarray(v) for k, v in item.items()
         if not isinstance(v, (str, dict))}
    vol = jr.prepare(b["imgs"], b["lidar2img"])
    o, d = jeval.rays_for_cams(jeval.eval_trans_mats(item, cfg),
                               jeval.eval_ray_grid(cfg))
    return jr.render(vol, o, d)["depth"]


def test_torch_ckpt_gives_the_jax_depth(occ, tmp_path):
    pth = _tiny_pth(occ["params"], tmp_path, "ref.pth")
    res = eval_depth.main(["--py-config", "tiny", "--synthetic",
                           "--num-samples", "1", "--batch", "96", "--device",
                           "cpu", "--torch-ckpt", pth])
    ref = _jax_depth(occ, SyntheticDataset(
        num_cams=2, input_size=(32, 48), img_size=(64, 96), num_classes=5,
        length=64))
    # the volume's 1e-4 through the render (test_tiny_frame_matches_jax)
    np.testing.assert_allclose(res["last_depth"].numpy().reshape(-1), ref,
                               rtol=1e-4, atol=1e-5)


def test_torch_ckpt_key_rules(occ, tmp_path):
    cfg = get_config("tiny")
    seeded = eval_depth.build_model(cfg, 42, torch.device("cpu"))
    color = {k: v.clone() for k, v in seeded.state_dict().items()
             if ".color_proj." in k}
    # no color_proj (an authentic reference checkpoint): the seeded one stays
    pth = _tiny_pth(occ["params"], tmp_path, "nocolor.pth",
                    drop=("head.model.field.color_proj.",))
    load_weights(seeded, torch_ckpt=pth, logger=get_logger())
    bridged = from_jax_variables({"params": occ["params"]})
    for k, v in seeded.state_dict().items():
        want = color[k] if k in color else bridged[k]
        assert torch.equal(v, want), k
    # a missing core key is an error
    pth = _tiny_pth(occ["params"], tmp_path, "nolifter.pth",
                    drop=("lifter.tpv_hw",))
    with pytest.raises(RuntimeError, match="lifter.tpv_hw"):
        load_weights(seeded, torch_ckpt=pth)


def test_ckpt_path_loads_the_train_checkpoint(tmp_path):
    work = str(tmp_path / "run")
    train.main(["--py-config", "tiny", "--synthetic", "--max-steps", "1",
                "--device", "cpu", "--work-dir", work])
    state = torch.load(f"{work}/ckpts/latest.pt")["model"]
    cfg, cpu = get_config("tiny"), torch.device("cpu")
    model = eval_depth.build_model(cfg, 42, cpu)
    assert any(not torch.equal(v, state[k])
               for k, v in model.state_dict().items())
    model.load_state_dict(state)
    logger = get_logger()
    ds = eval_iou.get_dataset(cfg, True)
    got = eval_depth.main(["--py-config", "tiny", "--synthetic",
                           "--num-samples", "1", "--batch", "96", "--device",
                           "cpu", "--ckpt-path", work])
    ref = eval_depth.evaluate(cfg, model, ds, cpu, 1, 96, logger)
    assert torch.equal(got["last_depth"], ref["last_depth"])
    flags = ["--py-config", "tiny", "--synthetic", "--num-samples", "1",
             "--resolution", "1.0", "--occ3d", "--sem", "--device", "cpu"]
    got = eval_iou.main(flags + ["--ckpt-path", work])
    ref = eval_iou.evaluate(cfg, model, ds, cpu, eval_iou.parse_args(flags),
                            logger)
    for k in ("iou_miou", "iou_iou", "miou_miou", "miou_iou"):
        assert got[k] == ref[k], k
