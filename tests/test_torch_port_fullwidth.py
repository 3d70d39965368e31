"""The port against the JAX package at full width on the CPU (slow, outside
Tier-1): the ``nuscenes_occ`` prepare (ResNet-50 + FPN, the 4-layer TPV
encoder, the (25, 257, 257, 25) decode), the geo-only depth render of a
few thousand rays of the eval grid and the occupancy query on a 64 x 64 x
40 slab of the 512 x 512 x 40 OpenOccupancy grid, at the same weights (the
JAX init with noise on every leaf, carried by
``bridge.from_jax_variables`` with ResNet-50's BatchNorm statistics), on
one synthetic frame, for two noise seeds. Each prints its errors, seconds
and the process's peak RSS (about 13 GB; 2 x 2 minutes on 8 CPU cores).

    JAX_PLATFORMS=cpu python -m pytest -m slow -s \\
        tests/test_torch_port_fullwidth.py

``tiny``-shaped parity runs in Tier-1 (``test_torch_port_slice.py``); this
checks that nothing that only shows at full width (the flagship's level
shapes, 257-cell planes, 256 samples per ray) breaks the agreement.
"""
import resource
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selfocc_tpu.configs.experiments import get_config as jget_config
from selfocc_tpu.data.synthetic import SyntheticDataset
from selfocc_tpu.models.segmentor import TPVSegmentor as JSegmentor
from selfocc_tpu.utils import eval_lib as jeval
from selfocc_tpu_torch.bridge import from_jax_variables
from selfocc_tpu_torch.configs.experiments import get_config
from selfocc_tpu_torch.models.segmentor import TPVSegmentor
from selfocc_tpu_torch.utils import eval_lib as teval
from test_torch_port_threads import share_cores_with_xdist_workers

share_cores_with_xdist_workers()

OPENOCC_PCR = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


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


def frame_parity(name: str, num_rays: int, chunk: int, seed: int = 0):
    """Prepare one synthetic frame in both packages and render ``num_rays``
    rays spread over the eval grid, at weights noised with ``seed``;
    returns the largest differences."""
    cfg = jget_config(name)
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
                       np.random.RandomState(seed))
    # ResNet-50's BatchNorm statistics travel with the weights; the tiny
    # backbone has none
    np_stats = jax.tree_util.tree_map(np.asarray,
                                      variables.get("batch_stats", {}))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, np_params),
                 "consts": variables["consts"],
                 **({"batch_stats": variables["batch_stats"]}
                    if "batch_stats" in variables else {})}
    jr = jeval.ChunkedRenderer(jmodel, variables, chunk=chunk, shard=False,
                               volume_dtype="float32", outputs=("depth",))
    jvol = jr.prepare(jnp.asarray(batch["imgs"]),
                      jnp.asarray(batch["lidar2img"]))
    jo, jd = jeval.rays_for_cams(jeval.eval_trans_mats(batch, cfg),
                                 jeval.eval_ray_grid(cfg))
    pick = np.linspace(0, jo.shape[0] - 1, num_rays).astype(np.int64)
    ref = jr.render(jvol, jnp.asarray(np.asarray(jo)[pick]),
                    jnp.asarray(np.asarray(jd)[pick]))

    tcfg = get_config(name)
    tmodel = TPVSegmentor(tcfg.model).eval()
    tmodel.load_state_dict(from_jax_variables(
        {"params": np_params, "batch_stats": np_stats}), strict=True)
    tr = teval.ChunkedRenderer(tmodel, chunk=chunk, outputs=("depth",))
    tvol = tr.prepare(torch.from_numpy(batch["imgs"]),
                      torch.from_numpy(batch["lidar2img"]))
    to, td = teval.rays_for_cams(
        torch.from_numpy(teval.eval_trans_mats(batch, tcfg)),
        teval.eval_ray_grid(tcfg))
    got = tr.render(tvol, to[pick], td[pick])

    # the occupancy query on the central 64 x 64 x 40 slab of the
    # OpenOccupancy 512 x 512 x 40 grid (JAX's points for both), each
    # package against its own volume
    jev = jeval.GridOccEvaluator(jmodel, variables, shard=False)
    _, _, _, xyz = jev._flat_grid(OPENOCC_PCR, 0.2)
    slab = np.array(xyz[224:288, 224:288]).reshape(-1, 3)
    jocc = jmodel.apply(variables, jvol, jnp.asarray(slab),
                        method="occ_from_volume")
    with torch.no_grad():
        tocc = tmodel.occ_from_volume(tvol, torch.from_numpy(slab))
    res = {"occ_points": int(slab.shape[0])}
    for k in ("sdf", "logits"):
        ref_k = np.asarray(jocc[k])
        res[f"occ_{k}"] = float(np.abs(tocc[k].numpy() - ref_k).max())
        res[f"occ_{k}_scale"] = float(np.abs(ref_k).max())
    top = np.sort(np.asarray(jocc["logits"]), axis=-1)
    differ = tocc["sem"].numpy() != np.asarray(jocc["sem"])
    res["occ_sem_differ"] = int(differ.sum())
    res["occ_sem_differ_beyond_ties"] = int(
        (differ & (top[..., -1] - top[..., -2] >= 1e-5)).sum())
    jvol = np.asarray(jvol)
    return dict(res, volume=float(np.abs(tvol.numpy() - jvol).max()),
                volume_scale=float(np.abs(jvol).max()),
                depth=float(np.abs(got["depth"] - ref["depth"]).max()),
                depth_scale=float(np.abs(ref["depth"]).max()),
                depth_finite=bool(np.isfinite(got["depth"]).all()))


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_nuscenes_occ_frame_matches_jax_at_full_width(seed):
    # fp32 through ResNet-50, 4 encoder layers and the decode, sums in
    # another order. Observed on the CPU at seeds 0 and 1: the volume 1.0e-6
    # and 7.8e-7 of its largest value, the depth (256 samples, sums of
    # weights times mids) 4.1e-5 and 3.2e-5 m, the occupancy slab's sdf and
    # logits at most 6.0e-7 of their largest values and no class apart.
    # Tolerances: about 10x those, and a class may differ only on a logit
    # tie (gap < 1e-5)
    t0 = time.perf_counter()
    res = frame_parity("nuscenes_occ", num_rays=4096, chunk=1024, seed=seed)
    res["seconds"] = time.perf_counter() - t0
    res["peak_rss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"full-width parity, seed {seed}: {res}")
    assert res["depth_finite"], res
    assert res["volume"] <= 1e-5 * max(1.0, res["volume_scale"]), res
    assert res["depth"] <= 4e-4, res
    for k in ("occ_sdf", "occ_logits"):
        assert res[k] <= 5e-6 * res[f"{k}_scale"], res
    assert res["occ_sem_differ_beyond_ties"] == 0, res
