"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, bound with ``ctypes``.

The library is built at first use from ``kernels/csrc/`` alone, into
``build/kernels/`` at the repository root, under a name keyed on a hash of
the sources and flags — so a fresh checkout builds once and an edited
source never loads a stale binary. Every ``.cu`` is compiled by its own
``nvcc`` process, all started together, and the objects are then linked.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> (argtypes, restype).
_SIGNATURES = {
    'hn_fused_level_fwd': ([_I] + [_P] * 13 + [_L, _I, _I, _P], _I),
    'hn_fused_level_layout': ([_I, _P, _P, _I], _I),
    'hn_fused_level_fwd_plan': ([_I, _P, _P, _P, _I], _I),
    'hn_tmpl_encode': ([_P, _L, _P, _L, _I, _L, _P, _P], _I),
    'hn_tmpl_ray_bias': ([_P, _P, _P, _L, _I, _I, _I, _P], _I),
    'hn_tmpl_rowprod': ([_P, _L, _L, _I, _I, _I, _P] + [_I] * 5
                        + [_P, _L, _I, _P, _P, _I, _I, _I, _P, _L, _I, _P],
                        _I),
    'hn_tmpl_dw': ([_P, _L, _P, _L, _L] + [_I] * 5
                   + [_P, _L, _L, _I, _L, _I, _P], _I),
    'hn_tmpl_rgb_head': ([_P, _P, _L, _I, _P, _P, _L, _P] + [_L] * 4
                         + [_I, _P], _I),
    'hn_tmpl_cond_bwd': ([_P, _L, _P, _L, _I, _P, _P, _P, _L, _L, _I, _L,
                          _I, _I, _I, _P], _I),
    'hn_tmpl_alpha_cond_bwd': ([_P] * 5 + [_L, _L, _L, _I, _I, _I, _P],
                               _I),
    'hn_tmpl_bneck_prep': ([_P, _P, _L, _P, _L, _I, _P, _P, _L, _P]
                           + [_L] * 5 + [_I, _P], _I),
    'hn_tmpl_posenc_bwd': ([_P, _L, _P, _L, _P, _L, _P, _P], _I),
    'hn_tmpl_reduce': ([_P, _I, _L, _P, _P], _I),
    'hn_fused_fields_bwd_blocks': ([_L], _I),
    'hn_fused_fields_bwd': ([_I] + [_P] * 12 + [_L, _I, _I, _P], _I),
    'hn_fused_fields_bwd_plan': ([_I, _P, _P, _P, _I], _I),
    'hn_fused_field_fwd': ([_I] + [_P] * 5 + [_L, _P], _I),
    'hn_fused_field_bwd': ([_I] + [_P] * 8 + [_L, _I, _P], _I),
    'hn_fused_field_bwd_plan': ([_I, _P, _P, _P, _I], _I),
    'hn_fused_se3_fwd': ([_P] * 5 + [_L, _P], _I),
    'hn_fused_se3_bwd': ([_P] * 8 + [_L, _I, _P], _I),
    'hn_fused_template_fwd': ([_P] * 8 + [_L, _I, _I, _P], _I),
    'hn_fused_template_fwd_plane': ([_P] * 8 + [_L, _I, _I, _P], _I),
    'hn_modular_fwd_plan': ([_I, _P, _P, _P, _I], _I),
    'hn_fused_jacobian_fwd': ([_P] * 4 + [_L, _P], _I),
    'hn_fused_jacobian_bwd': ([_P] * 8 + [_L, _I, _P], _I),
    'hn_fused_se3_jacobian_fwd': ([_P] * 5 + [_L, _P], _I),
    'hn_fused_se3_jacobian_bwd': ([_P] * 8 + [_L, _I, _P], _I),
    'hn_tangents_fwd_plan': ([_I, _P, _P, _P, _I], _I),
    'hn_fused_composite_fwd': ([_P] * 8 + [_L, _I, _I, _I, _I, _P], _I),
    'hn_fused_composite_bwd': ([_P] * 9 + [_L, _I, _I, _I, _P], _I),
    'hn_f32_level_fwd': ([_P] * 5 + [_I, _P, _P, _I] + [_P] * 6
                         + [_L, _I, _P], _I),
    'hn_f32_table_layout': ([_I, _P, _P, _I], _I),
    'hn_f32_trunk_fwd': ([_P] * 5 + [_L, _P], _I),
    'hn_f32_template_fwd': ([_P, _L, _I, _P, _I] + [_P] * 6 + [_L, _I, _P],
                            _I),
    'hn_f32_field_fwd': ([_I] + [_P] * 5 + [_L, _P], _I),
    'hn_f32_rowprod': ([_P, _L, _I, _P, _L, _I, _P, _L, _I, _P, _I, _P, _L,
                        _L, _P, _L, _I, _L, _P], _I),
    'hn_f32_dw': ([_P, _L, _I, _P, _L, _I, _P, _L, _I, _P, _L, _L, _I, _L,
                   _L, _L, _I, _P], _I),
    'hn_f32_reduce': ([_P, _I, _L, _L, _P, _P], _I),
    'hn_f32_field_encode': ([_P] * 4 + [_I] * 3 + [_P, _L, _I, _L, _P], _I),
    'hn_f32_tmpl_encode': ([_P, _L, _I, _I, _I, _P, _L, _I, _L, _I, _P, _P],
                           _I),
    'hn_f32_cond_rows': ([_P, _I, _I, _P, _L, _I, _L, _P], _I),
    'hn_f32_tmpl_posenc_bwd': ([_P, _L, _I, _I, _I, _P, _L, _P, _L, _L, _I,
                                _P, _P], _I),
    'hn_f32_alpha_cond_bwd': ([_P, _L, _P, _P, _I, _I, _P, _P, _L, _L, _I,
                               _P], _I),
    'hn_f32_fields_rows': ([_P] * 3 + [_I, _P, _L, _P, _L, _I, _P, _L, _I,
                                       _I, _P, _P, _L, _P], _I),
    'hn_f32_ray_sum': ([_P, _L, _I, _I, _P, _L, _P], _I),
    'hn_f32_trunk_encode': ([_P, _L] + [_P] * 4 + [_I, _I, _P, _P, _L, _L,
                                                  _P], _I),
    'hn_f32_trunk_posenc_bwd': ([_P, _L, _P, _P, _L, _P, _L, _L, _P], _I),
    'hn_f32_retract_bwd': ([_I] + [_P] * 3 + [_I, _P, _L, _P, _L, _P, _L, _P,
                                              _L, _L, _P], _I),
    'hn_f32_screw_rows': ([_P] * 3 + [_I, _P, _L, _P, _L, _P, _P, _L, _I, _I,
                                      _P, _P, _L, _P], _I),
    'hn_f32_plane_rows': ([_I] + [_P] * 3 + [_I, _P, _L, _P, _L, _P, _L, _I,
                                              _P, _I, _P, _P, _L, _P], _I),
    'hn_f32_jacobian_fwd': ([_P] * 4 + [_L, _P], _I),
    'hn_f32_se3_jacobian_fwd': ([_P] * 5 + [_L, _P], _I),
    'hn_f32_stream_encode': ([_I, _P, _L, _P, _P, _L, _I, _L, _P], _I),
    'hn_f32_stream_cot': ([_I, _P, _L, _P, _L, _L, _P], _I),
    'hn_f32_stream_enc_bwd': ([_I, _P, _L, _P, _P, _L, _P, _L, _L, _P], _I),
    'hn_error_string': ([_I], ctypes.c_char_p),
}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in ('.cu', '.cuh'))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libhypernerf_kernels_{h.hexdigest()[:16]}.so'


def _nvcc() -> str:
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(nvcc):
        raise RuntimeError('nvcc not found: the CUDA kernels are built with '
                           'the CUDA toolkit on the machine with the card')
    return nvcc


def build() -> Path:
    """Compile the sources if this hash has no library yet; returns its
    path. The compiler's report (registers, shared memory, spills) is kept
    beside it as ``<name>.log``, a section per source that starts with its
    ``nvcc`` process's wall seconds (``nvcc_seconds``)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        start = time.monotonic()
        for src in _sources():
            if src.suffix != '.cu':
                continue
            obj = os.path.join(tmp, src.stem + '.o')
            with open(obj + '.log', 'w') as out:
                jobs.append((src.name, obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, '-c', '-o', obj, str(src)],
                    stdout=out, stderr=subprocess.STDOUT)))
        seconds = {}
        while len(seconds) < len(jobs):
            for name, _, proc in jobs:
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.monotonic() - start
            time.sleep(0.05)
        log, failed = [], []
        for name, obj, proc in jobs:
            out = Path(obj + '.log').read_text()
            log.append(f'== {name}\nnvcc {seconds[name]:.1f} s\n{out}')
            if proc.returncode != 0:
                failed.append(name)
        linked = os.path.join(tmp, so.name)
        if not failed:
            link = subprocess.run(
                [nvcc, '-shared', '-o', linked, *[obj for _, obj, _ in jobs]],
                capture_output=True, text=True, check=False)
            log.append(f'== link\n{link.stdout}{link.stderr}')
            if link.returncode != 0:
                failed.append('link')
        text = '\n'.join(log)
        so.with_suffix('.log').write_text(text)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n{text[-6000:]}')
        os.replace(linked, so)
    return so


def build_log() -> str:
    """The compiler's report for the current library ('' if not built)."""
    log = library_path().with_suffix('.log')
    return log.read_text() if log.exists() else ''


def nvcc_seconds(log: str) -> dict:
    """{source: wall seconds from the start of the build to the end of its
    ``nvcc`` process} from a build log (every process starts together)."""
    out = {}
    for section in log.split('\n== ') if log else []:
        name, _, body = section.removeprefix('== ').partition('\n')
        if body.startswith('nvcc ') and body.split('\n', 1)[0].endswith(' s'):
            out[name.strip()] = float(body.split()[1])
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_tensor(name: str, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel's pointer arithmetic assumes."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f'{name}: want {dtype} {shape} contiguous on '
                         f'{device}, got {t.dtype} {tuple(t.shape)} on '
                         f'{t.device} (contiguous={t.is_contiguous()})')


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = library().hn_error_string(code).decode()
        raise RuntimeError(f'{name}: CUDA error {code}: {msg}')
