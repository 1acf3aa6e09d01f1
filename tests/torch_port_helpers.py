"""Shared helpers of the ``test_torch_*`` files: numpy views of JAX state, so
that one set of numpy inputs feeds the JAX package and the PyTorch port."""

import numpy as np
import torch

# The suite runs under several xdist workers: keep each worker's torch on one
# thread (also makes CPU reductions deterministic).
torch.set_num_threads(1)

# ``jax.jit`` options for a JAX side compiled at backend optimisation level
# 0: its multiply-adds are not contracted, so it rounds like the JAX
# function run op by op (and like the port), and it compiles faster than
# the optimised program; see tests/test_torch_conv_warp.py.
JIT_LEVEL0 = dict(compiler_options={"xla_backend_optimization_level": 0})


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t(a, dtype=torch.float32):
    """Writable CPU tensor from anything array-like."""
    return torch.tensor(np.array(a), dtype=dtype)


def jax_bsdf_to_numpy(bsdf):
    """The BSDF entries of the ``utils/convert.py`` scene dict from a JAX
    ``DiffuseBSDF`` or ``PrincipledBSDF``."""
    if hasattr(bsdf, "base_color"):
        d = {"bsdf": "principled", "base_color": np.array(bsdf.base_color), "roughness": np.array(bsdf.roughness),
             "specular": bsdf.specular}
        texs = {"base_color_tex": bsdf.base_color_tex, "roughness_tex": bsdf.roughness_tex}
    else:
        d = {"bsdf": "diffuse", "albedo": np.array(bsdf.albedo)}
        texs = {"albedo_tex": bsdf.albedo_tex}
    d.update({k: np.array(v) for k, v in texs.items() if v is not None})
    return d


def jax_scene_to_numpy(scene):
    """The scene dict of ``utils/convert.py`` from a JAX ``Scene`` (grid
    envmap or constant emitter, diffuse or principled BSDF, perspective
    rig)."""
    c = scene.cameras
    d = {
        "sdf": np.array(scene.sdf.data),
        "sdf_p": np.array(scene.sdf.p),
        "cam_origin": np.array(c.origin),
        "cam_rot": np.array(c.rot),
        "cam_tan_half_fov": np.array(c.tan_half_fov),
        "cam_resx": c.resx,
        "cam_resy": c.resy,
        **jax_bsdf_to_numpy(scene.bsdf),
    }
    e = scene.emitter
    if hasattr(e, "alias_idx"):
        d.update(
            envmap_image=np.array(e.image), envmap_pdf_table=np.array(e.pdf_table),
            envmap_alias_prob=np.array(e.alias_prob), envmap_alias_idx=np.array(e.alias_idx),
        )
    else:
        d["radiance"] = np.array(e.radiance)
    return d


def perturbed_sphere(res, seed=0, radius=0.3, sigma=0.01):
    """(res,)*3 float32 grid: sphere SDF at voxel centers + seeded noise."""
    if isinstance(res, int):
        res = (res, res, res)
    rng = np.random.default_rng(seed)
    zs, ys, xs = ((np.arange(n, dtype=np.float32) + 0.5) / n for n in res)
    z, y, x = np.meshgrid(zs, ys, xs, indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    return (r - radius + sigma * rng.standard_normal(r.shape)).astype(np.float32)
