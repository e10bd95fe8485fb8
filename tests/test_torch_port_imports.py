"""No module of the port imports the JAX stack, scikit-learn or the JAX
package: every ``.py`` file under ``crb_active_3ddet_torch/`` and
``chip_smoke.py`` is parsed and each of its ``import`` / ``from ... import``
statements (at any depth: inside functions too) is read.  The card's
machine has neither JAX's Flax nor scikit-learn."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'sklearn', 'crb_active_3ddet_tpu'}
FILES = sorted((ROOT / 'crb_active_3ddet_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split('.')[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split('.')[0])
    return roots


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports(path):
    assert not imported_roots(path) & FORBIDDEN


def test_the_walk_sees_every_kind_of_import(tmp_path):
    probe = tmp_path / 'probe.py'
    probe.write_text('import os\nimport jax.numpy as jnp\n'
                     'def f():\n    from sklearn.cluster import KMeans\n'
                     '    from crb_active_3ddet_tpu.utils import common\n'
                     'from . import sibling\n')
    assert imported_roots(probe) == {'os', 'jax', 'sklearn', 'crb_active_3ddet_tpu'}
    assert len(FILES) > 60 and ROOT / 'crb_active_3ddet_torch/tools/train.py' in FILES
