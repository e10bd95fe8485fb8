"""pv_rcnn_plusplus_resnet.yaml in the port vs the JAX package:
VoxelResBackBone8x (f32 always) and a CenterHead RPN whose decoded boxes the
early proposal step takes, then SPC, the vector-pool VSA and the vector-pool
RoI grid pool as in pv_rcnn_plusplus.yaml.  The reduced MODEL of
``tests/test_torch_pvrcnn_plusplus.py`` (``reduced``: 64 keypoints,
GRID_SIZE 3, narrow BEV, CenterHead at 16 channels and 64 boxes a frame),
from the same weights and the same host batch: the eval forward and the
eval step in one jitted JAX program, keypoints, RoI labels and validity,
predicted labels, validity and recall exactly, the floats within 1e-4.

Torch ops run on one thread.
"""

import pytest
import torch

from crb_active_3ddet_torch.models.backbones_3d.spconv_backbone import SparseBasicBlock
from crb_active_3ddet_torch.models.dense_heads.center_head import CenterHead

from test_torch_pvrcnn_plusplus import Pair, check_eval, jax_eval


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def ev():
    p = Pair('pv_rcnn_plusplus_resnet')
    p.jout, p.jpreds, p.jrec = jax_eval(p)
    return p


def test_resnet_topology(ev):
    m = ev.tmodel
    assert isinstance(m.dense_head, CenterHead) and m.dense_head.max_objs == 64
    assert any(isinstance(x, SparseBasicBlock) for x in m.backbone_3d.modules())
    assert m.module_topology.index('roi_proposal') == m.module_topology.index('dense_head') + 1
    assert m.roi_head.model_cfg['NMS_CONFIG']['TEST']['NMS_THRESH'] == 0.7


def test_eval_matches_jax(ev):
    tout = check_eval(ev, ev.jout, ev.jpreds, ev.jrec)
    assert int(tout['roi_valid'].sum()) <= 2 * 64           # CenterHead's boxes a frame
