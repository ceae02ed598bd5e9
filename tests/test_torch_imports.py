"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package, and its copies of the numpy-only modules (``configs``, ``opt``)
have not drifted from the JAX package's."""

import dataclasses
import os
import subprocess
import sys

import pytest

import hypernerf_tpu.configs as jax_configs
import hypernerf_tpu.opt as jax_opt
import hypernerf_tpu_torch.configs as port_configs
import hypernerf_tpu_torch.opt as port_opt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WALK = '''
import importlib, pkgutil, sys
import hypernerf_tpu_torch
names = ['hypernerf_tpu_torch'] + [
    m.name for m in pkgutil.walk_packages(hypernerf_tpu_torch.__path__,
                                          'hypernerf_tpu_torch.')]
for name in names + ['chip_smoke']:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'hypernerf_tpu'))
assert not bad, bad
assert len(names) >= 30, names
print(len(names))
'''


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """In a fresh interpreter, every module of ``hypernerf_tpu_torch`` and
    ``chip_smoke`` loads, and neither jax, flax, optax nor any module of
    ``hypernerf_tpu`` is in ``sys.modules`` afterwards."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _WALK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_port_sources_name_no_jax_package_import():
    """No source line of the port or of ``chip_smoke.py`` imports from
    ``hypernerf_tpu`` or from jax (a lazy import inside a function would
    escape the check above)."""
    bad = []
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for base, _, names in os.walk(os.path.join(ROOT, 'hypernerf_tpu_torch')):
        files += [os.path.join(base, n) for n in names if n.endswith('.py')]
    for path in files:
        with open(path) as f:
            for no, line in enumerate(f, 1):
                words = line.strip().split()
                if len(words) >= 2 and words[0] in ('import', 'from') and \
                        words[1].split('.')[0] in ('hypernerf_tpu', 'jax',
                                                   'flax', 'optax'):
                    bad.append(f'{os.path.relpath(path, ROOT)}:{no}')
    assert not bad, bad


@pytest.mark.parametrize('name', ['NerfConfig', 'TrainConfig'])
def test_config_copies_have_not_drifted(name):
    """Same fields, in the same order, with the same types and defaults,
    and a JSON written by either package loads in the other."""
    ours, theirs = getattr(port_configs, name), getattr(jax_configs, name)

    def spec(cls):
        return [(f.name, f.type, f.default, f.default_factory is
                 dataclasses.MISSING) for f in dataclasses.fields(cls)]

    assert spec(ours) == spec(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_config_json_round_trips_between_packages():
    for src, dst in ((port_configs, jax_configs), (jax_configs, port_configs)):
        cfg = src.NerfConfig(num_fine_samples=64, compute_dtype='bfloat16',
                             skips=(3,), pallas_bwd_tile=256)
        back = dst.NerfConfig.from_json(cfg.to_json())
        assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
        train = src.TrainConfig(batch_size=16384, decay_step=(2, 4))
        back = dst.TrainConfig.from_json(train.to_json())
        assert dataclasses.asdict(back) == dataclasses.asdict(train)


@pytest.mark.parametrize('eval_mode', [False, True])
def test_opt_copies_have_not_drifted(eval_mode):
    """Same flags with the same defaults, types and choices, and the same
    configurations resolved from them."""
    def flags(mod):
        return sorted(
            (tuple(a.option_strings), a.dest, repr(a.default),
             getattr(a.type, '__name__', repr(a.type)), repr(a.nargs),
             repr(a.choices), type(a).__name__)
            for a in mod.build_parser(eval_mode)._actions)

    assert flags(port_opt) == flags(jax_opt)
    argv = ['--root_dir', 'x', '--img_wh', '16', '12', '--N_importance', '32']
    ours = port_opt.configs_from_args(port_opt.get_opts(argv, eval_mode))
    theirs = jax_opt.configs_from_args(jax_opt.get_opts(argv, eval_mode))
    for a, b in zip(ours, theirs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
