"""The models' ``constrain`` sites on a (2, 2) ``("data", "model")`` mesh of
four gloo ranks: the prefill of one smoke model of each kind of block
reaches every site, and each returns a DTensor placed exactly as
``to_named(resolve_pspec(...))``. Helpers: ``tests/test_torch_dist.py``.
"""
import os
import sys

import numpy as np
import torch

from repro_torch.launch.mesh import spawn
from test_torch_dist import MESH, _cfg

# one smoke model of each kind of block (tests/test_torch_sharding.py's)
HOOK_ARCHS = ["qwen3-0.6b", "gemma2-2b", "dbrx-132b", "mamba2-370m", "hymba-1.5b",
              "whisper-base", "llama-3.2-vision-11b", "arctic-480b"]


def _record_sites(mesh):
    """Wrap every module's ``constrain`` to record, per call site, whether
    the returned placements equal ``to_named(resolve_pspec(...))``."""
    from repro_torch.dist import sharding as S
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    sites = {}

    def record(x, roles):
        caller = sys._getframe(1)
        y = S.constrain(x, roles)
        want = S.to_named(S.resolve_pspec(x.shape, roles, mesh), mesh)
        key = f"{os.path.basename(caller.f_code.co_filename)}:{caller.f_lineno}"
        sites[key] = sites.get(key, True) and tuple(y.placements) == want
        return y

    for mod in (L, M, T):
        mod.constrain = record
    return sites


def _sites_rank(rank):
    """Every constrain site of the zoo, through each kind of block's
    prefill, at batch 2 and 4 tokens (the smallest that every rule
    divides on the mesh)."""
    from repro_torch.dist.sharding import param_pspecs, place, use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model

    mesh = make_mesh(*MESH, device_type="cpu")
    sites = _record_sites(mesh)
    for arch in HOOK_ARCHS:
        cfg = _cfg(arch)
        api = build_model(cfg, "cpu")
        params = api.init(0)
        B, S = 2, 4
        batch = {"tokens": torch.from_numpy(
            np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))}
        extra = {"audio": ("frames", cfg.enc_frames), "vlm": ("image_embeds", cfg.n_img_tokens)}
        if cfg.family in extra:
            name, n = extra[cfg.family]
            batch[name] = 0.1 * torch.randn((B, n, cfg.d_model), generator=torch.Generator()
                                            .manual_seed(2))
        with torch.no_grad(), use_mesh(mesh):
            api.prefill(place(params, param_pspecs(params, mesh), mesh), batch)
    return sites


def test_constrain_sites_place_as_their_resolved_specs(tmp_path):
    """At each of the models' 14 ``constrain`` sites, reached through the
    prefill of every kind of block on the mesh, the DTensor returned has
    exactly ``to_named(resolve_pspec(...))``."""
    results = spawn(_sites_rank, 4, store_path=str(tmp_path / "store"), timeout=600)
    for sites in results:
        assert len(sites) == 14, sorted(sites)
        assert all(sites.values()), sites
