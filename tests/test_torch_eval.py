"""``python -m hypernerf_tpu_torch.eval`` end to end on a 16x12, 2-frame
synthetic LLFF scene: frames, GIF and per-frame + mean PSNR; and its device
rule: the CUDA card, the CPU only when ``HYPERNERF_PLATFORM=cpu`` asks."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from hypernerf_tpu.configs import NerfConfig
from hypernerf_tpu_torch.models.nerf import NerfModel
from hypernerf_tpu_torch.training.checkpoints import save_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import make_synthetic_scene  # noqa: E402


def _run_eval(tmp_path, platform):
    """Run the entry point on a fresh scene and weight file; ``platform`` is
    HYPERNERF_PLATFORM's value, None leaves it unset."""
    scene = make_synthetic_scene.make_scene(str(tmp_path / 'scene'),
                                            n_frames=2, width=16, height=12,
                                            focal=18.0)
    cfg = NerfConfig(num_embeddings=2, glo_dim=4, num_coarse_samples=8,
                     num_fine_samples=8, warp_depth=2, warp_width=16,
                     hyper_sheet_depth=2, hyper_sheet_width=16,
                     trunk_depth=2, trunk_width=32, rgb_branch_depth=1,
                     rgb_branch_width=16, skips=(1,), noise_std=None,
                     compute_dtype='float32')
    torch.manual_seed(0)
    weights = str(tmp_path / 'weights' / 'model.pt')
    save_weights(weights, NerfModel(cfg).state_dict(), cfg)

    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([REPO,
                                           os.environ.get('PYTHONPATH', '')]))
    env.pop('HYPERNERF_PLATFORM', None)
    if platform is not None:
        env['HYPERNERF_PLATFORM'] = platform
    return subprocess.run(
        [sys.executable, '-m', 'hypernerf_tpu_torch.eval', '--root_dir',
         scene, '--dataset_name', 'llff', '--img_wh', '16', '12', '--split',
         'test_train', '--weight_path', weights, '--scene_name', 'synth',
         '--chunk', '64', '--gif_fps', '5'],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_eval_writes_frames_gif_and_psnr(tmp_path):
    proc = _run_eval(tmp_path, 'cpu')
    assert proc.returncode == 0, proc.stderr
    out_dir = tmp_path / 'results' / 'llff' / 'synth'
    for i in range(2):
        img = np.asarray(Image.open(out_dir / f'{i:03d}.png'))
        assert img.shape == (12, 16, 3) and img.dtype == np.uint8
    gif = Image.open(out_dir / 'synth.gif')
    assert gif.n_frames == 2 and gif.size == (16, 12)
    lines = proc.stdout.splitlines()
    assert [ln.split(':')[0] for ln in lines[:2]] == ['frame 000',
                                                      'frame 001']
    psnrs = [float(ln.split()[-1]) for ln in lines[:2]]
    assert lines[2].startswith('Mean PSNR : ')
    assert abs(float(lines[2].split()[-1]) - np.mean(psnrs)) <= 0.01
    assert all(np.isfinite(psnrs))


def test_eval_without_a_card_is_an_error_not_a_cpu_run(tmp_path):
    """No HYPERNERF_PLATFORM=cpu: the entry point runs on the card, and
    where there is none it exits with an error that names the missing device
    and renders nothing."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the run would succeed')
    proc = _run_eval(tmp_path, None)
    assert proc.returncode != 0
    assert 'no CUDA device' in proc.stderr
    assert 'HYPERNERF_PLATFORM=cpu' in proc.stderr
    assert not (tmp_path / 'results').exists()


def test_render_device_rule(monkeypatch):
    from hypernerf_tpu_torch.eval import render_device
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'cpu')
    assert render_device() == torch.device('cpu')
    monkeypatch.setenv('HYPERNERF_PLATFORM', 'tpu')
    with pytest.raises(SystemExit, match='tpu'):
        render_device()
    monkeypatch.delenv('HYPERNERF_PLATFORM')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='no CUDA device'):
        render_device()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert render_device() == torch.device('cuda')
