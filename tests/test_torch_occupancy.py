"""The occupancy grid (``ops/occupancy.py``) against the JAX package: each
function of ``ops.occupancy`` on the same numpy inputs; the model's forward
with a grid, deterministic (coarse and fine, on the level branch and module
by module) and stochastic with the JAX model's own draws (its sorted coarse
and fine uniforms and its sigma noise, recomputed from its keys); the loss,
every gradient and one train step with the grid; and the grid's refresh,
``make_occupancy_update``, on the same jitter and ids. The JAX model runs its
XLA path (``use_pallas=False``) at float32, small widths.

A grid lookup floors the unit coordinate times G; two float32 sums of a
point may straddle a voxel edge, so every point looked up here lies at least
1e-4 of a cell from an edge (asserted, as a property of the drawn inputs).
Tolerances: lookups exact; points, gated weights and outputs 1e-5 (relative
where stated); z from an inverse CDF under its conditioning, 1e-5 plus the
CDF's error over the smallest bin mass times the widest bin, as
``test_torch_fused_composite.py`` bounds the fine draw; loss 1e-5; every
gradient 1e-4 of its largest entry; parameters after a step 1e-5 (the
reasons of ``test_torch_train_step.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypernerf_tpu.configs import NerfConfig, TrainConfig
from hypernerf_tpu.models.nerf import NerfModel as JaxNerfModel
from hypernerf_tpu.ops import occupancy as jocc
from hypernerf_tpu.ops.ray_dict import prepare_ray_dict as jax_ray_dict
from hypernerf_tpu.ops.sampling import sorted_uniform
from hypernerf_tpu.parallel.mesh import create_mesh
from hypernerf_tpu.training.losses import mse_loss as jax_mse_loss
from hypernerf_tpu.training.optimizers import get_optimizer as jax_optimizer
from hypernerf_tpu.training.train_state import TrainState as JaxTrainState
from hypernerf_tpu.training.train_state import \
    make_occupancy_update as jax_make_occupancy_update
from hypernerf_tpu.training.train_state import \
    make_train_step as jax_make_train_step
from hypernerf_tpu_torch import configs as port_configs
from hypernerf_tpu_torch.convert import params_from_jax, params_to_jax
from hypernerf_tpu_torch.flagship import (bench_grid, flagship_config,
                                          flagship_train_setup)
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.ops import occupancy as occ
from hypernerf_tpu_torch.ops.ray_dict import prepare_ray_dict
from hypernerf_tpu_torch.training.losses import mse_loss
from hypernerf_tpu_torch.training.optimizers import get_optimizer
from hypernerf_tpu_torch.training.renderer import render_rays
from hypernerf_tpu_torch.training.train_state import (TrainState,
                                                      make_occupancy_update,
                                                      make_train_step)
from tests.test_torch_train_step import (ARCH, BATCH, N, S, STEPS_PER_EPOCH,
                                         TRAIN, _assert_trees_close, _batch,
                                         _flat, _flax_params, _step_keys)

G = 8
BBOX = ((-2.0,) * 3, (2.0,) * 3)
OCC = dict(use_occupancy_grid=True, occupancy_resolution=G,
           occupancy_probes=16)
# The level-kernel branch (the small flagship) and the per-module branch
# (two GLO tables).
BRANCHES = {'level': {}, 'modules': dict(share_glo=False)}
MARGIN = 1e-4  # of a cell, between a looked-up point and a voxel edge
TOL = 1e-5


def _edge_margin(points, res=G, bbox=BBOX):
    """The smallest distance, in cells, of (..., 3) points inside the box
    from a voxel edge (float64)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    uvw = (pts - np.asarray(bbox[0])) / (np.asarray(bbox[1])
                                         - np.asarray(bbox[0])) * res
    inside = np.all((uvw >= 0) & (uvw < res), axis=-1)
    frac = uvw[inside] - np.floor(uvw[inside])
    return float(np.minimum(frac, 1.0 - frac).min()) if inside.any() else 1.0


def _grid(seed=3, res=G):
    """A sparse numpy grid: a third of the voxels occupied, densities in
    [0, 5)."""
    rs = np.random.RandomState(seed)
    return (rs.rand(res, res, res) * 5 * (rs.rand(res, res, res) < 0.35)
            ).astype(np.float32)


def _z_tol(z_edges, weights, cdf_err=8 * 2.0 ** -24):
    """1e-5 plus an inverse CDF's conditioning: the CDF's error over the
    smallest bin mass, times the widest bin (numpy, per call)."""
    w = np.asarray(weights, np.float64) + 1e-5
    mass = (w / w.sum(-1, keepdims=True)).min()
    width = np.diff(np.asarray(z_edges, np.float64), axis=-1).max()
    return TOL + cdf_err / mass * width


# -- ops/occupancy, function by function --------------------------------------

def _points(n, seed):
    """(n, 3) points in and around the box, each coordinate at least
    MARGIN of a cell from a voxel edge."""
    rs = np.random.RandomState(seed)
    cells = rs.randint(-2, G + 2, (n, 3)) + rs.uniform(2 * MARGIN,
                                                       1 - 2 * MARGIN, (n, 3))
    return (-2.0 + cells * 4.0 / G).astype(np.float32)


def test_init_grid():
    grid = occ.init_grid(G)
    assert grid.shape == (G, G, G) and grid.dtype == torch.float32
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jocc.init_grid(G)))


def test_grid_lookup_matches_jax():
    grid = _grid()
    pts = _points(500, seed=1)
    assert _edge_margin(pts) >= MARGIN
    want = np.asarray(jocc.grid_lookup(jnp.asarray(grid), jnp.asarray(pts),
                                       BBOX))
    got = occ.grid_lookup(torch.from_numpy(grid), torch.from_numpy(pts), BBOX)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() and (want > 0).any()
    # The flat index is (i G + j) G + k: voxel (1, 2, 3)'s centre.
    ramp = torch.arange(G ** 3, dtype=torch.float32).reshape(G, G, G)
    centre = torch.tensor([[-2 + 4 * (1.5 / G), -2 + 4 * (2.5 / G),
                            -2 + 4 * (3.5 / G)]])
    assert occ.grid_lookup(ramp, centre, BBOX).item() == ramp[1, 2, 3]


@pytest.mark.parametrize('jitter', [False, True])
def test_cell_points_matches_jax(jitter):
    key = jax.random.PRNGKey(4) if jitter else None
    want = np.asarray(jocc.cell_points(G, BBOX, key=key))
    u = None
    if jitter:
        u = torch.from_numpy(np.array(jax.random.uniform(key, (G ** 3, 3))))
    got = occ.cell_points(G, BBOX, u=u)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # Each point lies in the cell of its flat index.
    ramp = torch.arange(G ** 3, dtype=torch.float32).reshape(G, G, G)
    if not jitter:
        np.testing.assert_array_equal(occ.grid_lookup(ramp, got, BBOX),
                                      ramp.reshape(-1))
    gen = torch.Generator().manual_seed(0)
    drawn = occ.cell_points(G, BBOX, generator=gen)
    assert (drawn - occ.cell_points(G, BBOX)).abs().max() <= 2.0 / G


def test_update_grid_matches_jax():
    grid = _grid(seed=5)
    sigma = np.random.RandomState(6).rand(G ** 3).astype(np.float32) * 4
    want = np.asarray(jocc.update_grid(jnp.asarray(grid), jnp.asarray(sigma),
                                       0.95))
    got = occ.update_grid(torch.from_numpy(grid), torch.from_numpy(sigma),
                          0.95)
    np.testing.assert_array_equal(got.numpy(), want)


def _rays_through_box(n, seed):
    """Origins near -1.5 on z, directions into the box: (origins, dirs)."""
    rs = np.random.RandomState(seed)
    o = np.concatenate([rs.uniform(-1, 1, (n, 2)),
                        np.full((n, 1), -1.5)], 1).astype(np.float32)
    d = (np.array([0.0, 0.0, 1.0]) + rs.randn(n, 3) * 0.2).astype(np.float32)
    return o, d


def test_gate_fine_weights_matches_jax():
    grid = _grid(seed=7)
    o, d = _rays_through_box(16, seed=10)
    z = np.sort(np.random.RandomState(11).uniform(0.2, 3.0, (16, 12)),
                -1).astype(np.float32)
    w = np.random.RandomState(12).rand(16, 12).astype(np.float32)
    assert _edge_margin(o[:, None] + z[..., None] * d[:, None]) >= MARGIN
    want = np.asarray(jocc.gate_fine_weights(
        jnp.asarray(grid), jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
        jnp.asarray(w), BBOX, 0.01))
    got = occ.gate_fine_weights(torch.from_numpy(grid), torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(z),
                                torch.from_numpy(w), BBOX, 0.01)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=0)
    assert (want < 0.02 * w).any() and (want > w).any()


@pytest.mark.parametrize('stratified', [False, True])
def test_sample_occupancy_rays_matches_jax(stratified):
    grid = _grid(seed=11)
    o, d = _rays_through_box(32, seed=12)
    near, far, m, s = 0.2, 3.2, 24, 16
    t = np.linspace(0, 1, m + 1)
    z_mid = near + (far - near) * 0.5 * (t[1:] + t[:-1])
    assert _edge_margin(o[:, None] + z_mid[:, None] * d[:, None]) >= MARGIN
    key = jax.random.PRNGKey(13)
    z_j, p_j = jocc.sample_occupancy_rays(
        key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(grid), BBOX, s,
        near, far, m, stratified, 0.01)
    u = None
    if stratified:  # the u the JAX draw inverts, for this key
        u = torch.from_numpy(np.array(sorted_uniform(key, 32, s)))
    z_t, p_t = occ.sample_occupancy_rays(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(grid),
        BBOX, s, near, far, m, stratified, 0.01, u=u)
    occ_j = np.asarray(jocc.grid_lookup(jnp.asarray(grid), jnp.asarray(
        o[:, None] + z_mid[:, None] * d[:, None]), BBOX))
    weights = occ_j / np.maximum(occ_j.max(-1, keepdims=True), 1e-6) + 0.01
    tol = _z_tol(near + (far - near) * t[None], weights)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=tol * 2)
    assert (np.diff(z_t.numpy(), axis=-1) >= 0).all()
    # The draw concentrates where the grid is occupied.
    hit = occ.grid_lookup(torch.from_numpy(grid), p_t, BBOX) > 0
    probes_hit = (occ_j > 0).mean()
    assert hit.float().mean().item() > probes_hit


# -- the model ---------------------------------------------------------------

def _jax_cfg(branch):
    return NerfConfig(use_pallas=False, **{**ARCH, **OCC,
                                           **BRANCHES[branch]})


def _port_cfg(branch):
    return port_configs.NerfConfig(**{**ARCH, **OCC, **BRANCHES[branch]})


@functools.cache
def _params(branch):
    """flax init of the branch's model with the warp and sheet heads scaled
    up (``test_torch_train_step._flax_params``), as numpy."""
    if not BRANCHES[branch]:
        return _flax_params()
    model = JaxNerfModel(_jax_cfg(branch))
    params = jax.device_get(jax.jit(model.init)(
        {'params': jax.random.PRNGKey(0)},
        jax_ray_dict(jnp.asarray(_batch()[0])))['params'])
    params = jax.tree.map(np.array, params)
    params['warp_field']['mlp']['logit']['kernel'] *= 300.0
    params['hyper_sheet_mlp']['mlp']['logit']['kernel'] *= 1e4
    return params


def _port_model(branch):
    model = NerfModel(_port_cfg(branch))
    model.load_state_dict(params_from_jax(_params(branch)))
    return model


def _probes(rays, cfg):
    """(z_edges (B, M + 1), probe points (B, M, 3)) of the grid's coarse
    draw, numpy."""
    o, d = rays[:, :3], rays[:, 3:6]
    t = np.linspace(0, 1, cfg.occupancy_probes + 1, dtype=np.float32)
    z_edges = rays[:, 6:7] * (1 - t) + rays[:, 7:8] * t
    z_mid = 0.5 * (z_edges[:, 1:] + z_edges[:, :-1])
    return z_edges, o[:, None] + z_mid[..., None] * d[:, None]


def _lookup(grid, pts):
    return np.asarray(jocc.grid_lookup(jnp.asarray(grid), jnp.asarray(pts),
                                       BBOX))


def _normalised(occ_vals):
    return occ_vals / np.maximum(occ_vals.max(-1, keepdims=True), 1e-6) \
        + 0.01


def _cdf(weights):
    w = np.asarray(weights, np.float64) + 1e-5
    return np.cumsum(w / w.sum(-1, keepdims=True), -1)


def _depths(points, rays):
    """Depths along each ray of (B, S, 3) points."""
    o, d = rays[:, :3], rays[:, 3:6]
    return np.einsum('bsk,bk->bs', np.asarray(points) - o[:, None], d) / (
        d * d).sum(-1, keepdims=True)


def _fine_z_tol(port_coarse_weights, want, grid, rays):
    """The fine depths' bound: the fine draw inverts the coarse weights
    gated at the coarse depths, and the two packages' coarse weights differ
    in their last bits, which the CDF carries to the depths over each bin's
    mass (``_z_tol``)."""
    z_c = _depths(want['coarse']['points'], rays)
    gate = _normalised(_lookup(grid, want['coarse']['points'][:, 1:-1]))
    w_want = want['coarse']['weights'][:, 1:-1] * gate
    cdf_err = np.abs(_cdf(port_coarse_weights[:, 1:-1] * gate)
                     - _cdf(w_want)).max()
    return _z_tol(0.5 * (z_c[:, 1:] + z_c[:, :-1]), w_want,
                  8 * 2.0 ** -24 + cdf_err)


@pytest.mark.parametrize('branch', list(BRANCHES))
def test_deterministic_render_with_a_grid_matches_jax(branch):
    """Coarse and fine outputs of the grid-guided render, through the
    renderer in two chunks: rgb and acc at 1e-5 relative, the fine level's
    depths also under the fine draw's conditioning (``_fine_z_tol``); the
    grid moves the render."""
    rays, _ = _batch()
    grid = _grid()
    jmodel = JaxNerfModel(_jax_cfg(branch))
    want = jax.device_get(jax.jit(functools.partial(
        jmodel.apply, deterministic=True, return_points=True))(
            {'params': _params(branch)}, jax_ray_dict(jnp.asarray(rays)),
            occupancy_grid=jnp.asarray(grid)))
    assert _edge_margin(_probes(rays, _port_cfg(branch))[1]) >= MARGIN
    assert _edge_margin(want['coarse']['points']) >= MARGIN
    model = _port_model(branch)
    tgrid = torch.from_numpy(grid)
    got = render_rays(model, rays, chunk=BATCH // 2, occupancy_grid=tgrid)
    without = render_rays(model, rays, chunk=BATCH // 2)
    with torch.no_grad():
        weights = model(prepare_ray_dict(torch.from_numpy(rays)),
                        occupancy_grid=tgrid)['coarse']['weights'].numpy()
    z_tol = _fine_z_tol(weights, want, grid, rays)
    for level in ('coarse', 'fine'):
        for k in ('rgb', 'depth', 'med_depth', 'acc'):
            atol = z_tol if level == 'fine' and 'depth' in k else TOL
            np.testing.assert_allclose(got[level][k], want[level][k],
                                       rtol=TOL, atol=atol,
                                       err_msg=f'{level}/{k}')
    assert np.abs(got['fine']['rgb'] - without['fine']['rgb']).max() > 1e-4


def _occ_draws(jmodel, params, k_sample, k_noise):
    """The JAX model's draws from these rngs, in its order: the grid's
    coarse u and the fine u (each ``sorted_uniform`` of a 'sampling' key),
    one sigma noise per level."""
    def keys(m):
        return (m.make_rng('sampling'), m.make_rng('sampling'),
                m.make_rng('sigma_noise'), m.make_rng('sigma_noise'))

    k_coarse, k_fine, k_n0, k_n1 = jmodel.apply(
        {'params': params}, rngs={'sampling': k_sample,
                                  'sigma_noise': k_noise}, method=keys)
    draws = {
        'coarse_u': sorted_uniform(k_coarse, BATCH, S),
        'fine_u': sorted_uniform(k_fine, BATCH, N),
        'noise_coarse': jax.random.normal(k_n0, (BATCH, S), jnp.float32),
        'noise_fine': jax.random.normal(k_n1, (BATCH, S + N), jnp.float32),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize('branch', list(BRANCHES))
def test_stochastic_forward_loss_and_gradients_match_jax(branch):
    """With the JAX model's draws: z of both levels under the conditioning
    bound (read from ``return_points``), the outputs, the loss and every
    parameter's gradient."""
    rays, rgbs = _batch()
    grid = _grid()
    cfg = _port_cfg(branch)
    jmodel = JaxNerfModel(_jax_cfg(branch))
    params = _params(branch)
    k_sample, k_noise = _step_keys(jax.random.PRNGKey(1), 0)
    rd = jax_ray_dict(jnp.asarray(rays))

    def jax_loss(p):
        out = jmodel.apply({'params': p}, rd,
                           rngs={'sampling': k_sample,
                                 'sigma_noise': k_noise},
                           occupancy_grid=jnp.asarray(grid),
                           return_points=True)
        return jax_mse_loss(out, jnp.asarray(rgbs)), out

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(params)
    want = jax.device_get(want)
    draws = _occ_draws(jmodel, params, k_sample, k_noise)
    z_edges, probes = _probes(rays, cfg)
    assert _edge_margin(probes) >= MARGIN
    assert _edge_margin(want['coarse']['points']) >= MARGIN

    model = _port_model(branch)
    td = prepare_ray_dict(torch.from_numpy(rays))
    tgrid = torch.from_numpy(grid)
    with torch.no_grad():
        pts = model(td, deterministic=False, draws=draws,
                    occupancy_grid=tgrid, return_points=True)
    # The coarse draw inverts the probes' weights, the same on both sides;
    # the fine one the gated coarse weights (``_fine_z_tol``).
    np.testing.assert_allclose(
        _depths(pts['coarse']['points'].numpy(), rays),
        _depths(want['coarse']['points'], rays), rtol=0,
        atol=_z_tol(z_edges, _normalised(_lookup(grid, probes))))
    np.testing.assert_allclose(
        _depths(pts['fine']['points'].numpy(), rays),
        _depths(want['fine']['points'], rays), rtol=0,
        atol=_fine_z_tol(pts['coarse']['weights'].numpy(), want, grid, rays))

    out = model(td, deterministic=False, draws=draws, occupancy_grid=tgrid)
    loss = mse_loss(out, torch.from_numpy(rgbs))
    assert abs(loss.item() - float(want_loss)) <= TOL
    for level in ('coarse', 'fine'):
        np.testing.assert_allclose(out[level]['rgb'].detach().numpy(),
                                   want[level]['rgb'], rtol=0, atol=TOL)
    loss.backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    _assert_trees_close(got, jax.device_get(want_grads), 1e-4, True)
    for k, g in _flat(got):
        assert np.abs(g).max() > 0, k


def _jax_state(cfg, train_cfg, grid):
    tx = jax_optimizer(train_cfg, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, _flax_params())
    return tx, JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=tx.init(params),
                             occupancy=jnp.asarray(grid))


def _port_state(grid):
    cfg = _port_cfg('level')
    train_cfg = port_configs.TrainConfig(**TRAIN)
    model = NerfModel(cfg).train()
    model.load_state_dict(params_from_jax(_flax_params()))
    optimizer, schedule = get_optimizer(train_cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
    state = TrainState(0, model, optimizer, seed=0,
                       occupancy=torch.from_numpy(grid))
    return cfg, train_cfg, state, schedule


def test_train_step_with_a_grid_matches_jax():
    """One step of each package's ``make_train_step`` with the grid: the
    loss, psnr and every parameter after Adam; the grid rides along."""
    rays, rgbs = _batch()
    grid = _grid()
    cfg = _jax_cfg('level')
    train_cfg = TrainConfig(**TRAIN)
    tx, jstate = _jax_state(cfg, train_cfg, grid)
    jmodel = JaxNerfModel(cfg)
    jstep = jax_make_train_step(jmodel, tx, cfg, train_cfg,
                                create_mesh(num_devices=1),
                                explicit_batch=True)
    base_rng = jax.random.PRNGKey(1)
    draws = _occ_draws(jmodel, jax.device_get(jstate.params),
                       *_step_keys(base_rng, 0))
    jstate, jmetrics = jstep(jstate, jnp.asarray(rays), jnp.asarray(rgbs),
                             base_rng)
    pcfg, ptrain, state, schedule = _port_state(grid)
    step_fn = make_train_step(state.model, state.optimizer, pcfg, ptrain,
                              'cpu', schedule=schedule, explicit_batch=True)
    metrics = step_fn(state, torch.from_numpy(rays), torch.from_numpy(rgbs),
                      draws=draws)
    assert state.step == 1 == int(jstate.step)
    assert abs(metrics['loss'].item() - float(jmetrics['loss'])) <= TOL
    assert abs(metrics['psnr'].item() - float(jmetrics['psnr'])) <= 1e-3
    _assert_trees_close(params_to_jax(state.model.state_dict()),
                        jax.device_get(jstate.params), TOL, False)
    np.testing.assert_array_equal(state.occupancy.numpy(), grid)


def test_grid_refresh_matches_jax():
    """``make_occupancy_update`` on the JAX refresh's jitter and ids (from
    its keys), from a non-zero grid at step 3: the EMA-max of the max over
    the ids of ``query_sigma``, 1e-5 relative."""
    cfg = _jax_cfg('level')
    train_cfg = dataclasses.replace(TrainConfig(**TRAIN),
                                    occupancy_probe_ids=3)
    grid = _grid(seed=14) * 0.5
    tx, jstate = _jax_state(cfg, train_cfg, grid)
    jstate = jstate.replace(step=jnp.asarray(3, jnp.int32))
    base_rng = jax.random.PRNGKey(4)  # three different ids: [3, 0, 2]
    want = np.asarray(jax_make_occupancy_update(
        JaxNerfModel(cfg), cfg, train_cfg)(jstate, base_rng).occupancy)
    k_jit, k_id = jax.random.split(jax.random.fold_in(base_rng, 3))
    u = torch.from_numpy(np.array(jax.random.uniform(k_jit, (G ** 3, 3))))
    ids = torch.from_numpy(np.asarray(jax.random.randint(
        k_id, (3,), 0, cfg.num_embeddings)).astype(np.int64))
    assert len(set(ids.tolist())) == 3
    pcfg, _, state, _ = _port_state(grid)
    state.step = 3
    ptrain = port_configs.TrainConfig(**{**TRAIN, 'occupancy_probe_ids': 3})
    update = make_occupancy_update(state.model, pcfg, ptrain)
    got = update(state, u=u, ids=ids)
    assert got is state.occupancy and got.shape == (G, G, G)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-7)
    # The max over the ids shows: no one id's density gives the grid.
    with torch.no_grad():
        pts = occ.cell_points(G, BBOX, u=u)
        for i in ids.tolist():
            one = state.model.query_sigma(
                pts, torch.full((G ** 3, 1), i, dtype=torch.int64))
            assert (occ.update_grid(torch.from_numpy(grid), one, 0.95)
                    != got).any()
    # Both terms of the EMA-max show: fresh density and decayed cells.
    assert (want > grid * 0.95).any() and (want == grid * 0.95).any()
    # Drawn from the refresh's own generator: the same draws for the same
    # (seed, step), others for another step.
    _, _, again, _ = _port_state(grid)
    again.step = 3
    a = update(again).clone()
    again.occupancy = torch.from_numpy(grid)
    np.testing.assert_array_equal(update(again).numpy(), a.numpy())
    again.occupancy, again.step = torch.from_numpy(grid), 4
    assert not torch.equal(update(again), a)


def test_state_without_a_grid_gets_a_fresh_one():
    """A grid configuration's TrainState starts from ``init_grid`` (zeros);
    a configuration without one carries None, and its forward ignores a
    grid (the JAX model's rule)."""
    pcfg, _, state, _ = _port_state(_grid())
    fresh = TrainState(0, state.model, state.optimizer)
    assert fresh.occupancy.shape == (G, G, G)
    assert not fresh.occupancy.any()
    plain = NerfModel(port_configs.NerfConfig(**ARCH))
    plain.load_state_dict(params_from_jax(_flax_params()))
    assert TrainState(0, plain, state.optimizer).occupancy is None
    rays = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        a = plain(prepare_ray_dict(rays))['fine']['rgb']
        b = plain(prepare_ray_dict(rays),
                  occupancy_grid=torch.from_numpy(_grid()))['fine']['rgb']
    assert torch.equal(a, b)


def test_the_occupancy_configuration_builds_and_trains():
    """``flagship_config('occupancy')``: the flagship at 32 + 32 with the
    grid (G = 64, 64 probes, floor 0.01, box +-2); its train setup carries
    ``bench_grid`` and takes a step on the CPU (the plain versions)."""
    cfg = flagship_config('occupancy')
    assert (cfg.num_coarse_samples, cfg.num_fine_samples) == (32, 32)
    assert (cfg.use_occupancy_grid, cfg.occupancy_resolution,
            cfg.occupancy_probes, cfg.occupancy_floor,
            cfg.occupancy_bbox_min, cfg.occupancy_bbox_max) == (
                True, 64, 64, 0.01, -2.0, 2.0)
    state, step_fn, rays, rgbs = flagship_train_setup(
        'cpu', batch_size=32, n_rays=4096, config='occupancy')
    grid = bench_grid(cfg, 'cpu')
    assert torch.equal(state.occupancy, grid)
    assert 0.0 <= grid.min() and grid.max() < 1.0
    metrics = step_fn(state, rays, rgbs)
    assert np.isfinite(metrics['loss'].item()) and state.step == 1
