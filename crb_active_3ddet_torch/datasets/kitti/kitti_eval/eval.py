"""KITTI-official AP evaluation (R11 + R40), orchestrated in numpy with the
greedy-matching inner loops in native C++ (ctypes).

Copy of ``crb_active_3ddet_tpu/datasets/kitti/kitti_eval/eval.py`` (parity:
``pcdet/datasets/kitti/kitti_object_eval_python/eval.py``) —
get_thresholds :10-27, clean_data :30-83, calculate_iou_partly :344-411,
_prepare_data :413-448, eval_class :450-552, get_mAP/get_mAP_R40 :555-566,
do_eval :578-626, get_official_eval_result :639-721.  The numba.cuda rotated
IoU and numba.jit statistics loops live in ``native/kitti_eval.cpp``.
"""

from __future__ import annotations

import ctypes
import io as sysio

import numpy as np

from ....native import load_library


def _lib():
    lib = load_library('kitti_eval')
    if not getattr(lib, '_configured', False):
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.rotated_overlap.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64,
                                        ctypes.c_int, dp]
        lib.d3_overlap_kernel.argtypes = [dp, ctypes.c_int64, dp,
                                          ctypes.c_int64, dp, ctypes.c_int]
        lib.image_overlap.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64,
                                      ctypes.c_int, dp]
        lib.compute_statistics.argtypes = [
            dp, ctypes.c_int64, ctypes.c_int64, dp, dp, dp, dp, dp,
            ctypes.c_int64, ip, ip, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, dp, dp, ip]
        lib.fused_statistics.argtypes = [
            dp, ip, ip, ip, ip, ip, ip, ip, dp, dp, dp, dp, dp, ip, ip,
            ctypes.c_int64, ctypes.c_int, ctypes.c_double, dp,
            ctypes.c_int64, ctypes.c_int, dp]
        lib._configured = True
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _c(a, dtype=np.float64):
    return np.ascontiguousarray(a, dtype=dtype)


def rotate_iou_eval(boxes, qboxes, criterion=-1):
    """(N, 5) × (K, 5) rotated boxes (cx, cy, w, h, angle) → (N, K)."""
    boxes = _c(boxes)
    qboxes = _c(qboxes)
    out = np.zeros((boxes.shape[0], qboxes.shape[0]), np.float64)
    if out.size:
        _lib().rotated_overlap(_dptr(boxes), boxes.shape[0], _dptr(qboxes),
                               qboxes.shape[0], criterion, _dptr(out))
    return out


def image_box_overlap(boxes, query_boxes, criterion=-1):
    boxes = _c(boxes)
    query_boxes = _c(query_boxes)
    out = np.zeros((boxes.shape[0], query_boxes.shape[0]), np.float64)
    if out.size:
        _lib().image_overlap(_dptr(boxes), boxes.shape[0], _dptr(query_boxes),
                             query_boxes.shape[0], criterion, _dptr(out))
    return out


def bev_box_overlap(boxes, qboxes, criterion=-1):
    return rotate_iou_eval(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame boxes (N, 7) [x, y, z, l, h, w, ry]."""
    boxes = _c(boxes)
    qboxes = _c(qboxes)
    rinc = rotate_iou_eval(boxes[:, [0, 2, 3, 5, 6]],
                           qboxes[:, [0, 2, 3, 5, 6]], 2)
    if rinc.size:
        _lib().d3_overlap_kernel(_dptr(boxes), boxes.shape[0], _dptr(qboxes),
                                 qboxes.shape[0], _dptr(rinc), criterion)
    return rinc


def get_thresholds(scores, num_gt, num_sample_pts=41):
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and (i < (len(scores) - 1))):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting',
                   'truck']
    MIN_HEIGHT = [40, 25, 25]
    MAX_OCCLUSION = [0, 1, 2]
    MAX_TRUNCATION = [0.15, 0.3, 0.5]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno['name'])
    num_dt = len(dt_anno['name'])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno['bbox'][i]
        gt_name = gt_anno['name'][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(num_dt):
        valid_class = 1 if dt_anno['name'][i].lower() == current_cls_name else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def calculate_iou_partly(dt_annos, gt_annos, metric):
    """Per-frame (det, gt) overlap matrices. Parity :344-411 (we compute
    per-frame directly; the reference's 'parts' were a numba batching trick)."""
    assert len(dt_annos) == len(gt_annos)
    overlaps = []
    for dt, gt in zip(dt_annos, gt_annos):
        if metric == 0:
            dt_boxes = dt['bbox']
            gt_boxes = gt['bbox']
            ov = image_box_overlap(_c(dt_boxes), _c(gt_boxes))
        elif metric == 1:
            dt_boxes = np.concatenate(
                [dt['location'][:, [0, 2]], dt['dimensions'][:, [0, 2]],
                 dt['rotation_y'][..., np.newaxis]], axis=1)
            gt_boxes = np.concatenate(
                [gt['location'][:, [0, 2]], gt['dimensions'][:, [0, 2]],
                 gt['rotation_y'][..., np.newaxis]], axis=1)
            ov = bev_box_overlap(dt_boxes, gt_boxes)
        elif metric == 2:
            dt_boxes = np.concatenate(
                [dt['location'], dt['dimensions'],
                 dt['rotation_y'][..., np.newaxis]], axis=1)
            gt_boxes = np.concatenate(
                [gt['location'], gt['dimensions'],
                 gt['rotation_y'][..., np.newaxis]], axis=1)
            ov = d3_box_overlap(dt_boxes, gt_boxes)
        else:
            raise ValueError('unknown metric')
        overlaps.append(ov.astype(np.float64))
    total_dt_num = np.array([len(a['name']) for a in dt_annos])
    total_gt_num = np.array([len(a['name']) for a in gt_annos])
    return overlaps, total_gt_num, total_dt_num


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_dc_num = []
    total_num_valid_gt = 0
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt_annos[i], dt_annos[i], current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dc_bboxes = np.stack(dc_bboxes, 0).astype(np.float64) if dc_bboxes \
            else np.zeros((0, 4), np.float64)
        total_dc_num.append(dc_bboxes.shape[0])
        dontcares.append(dc_bboxes)
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt_annos[i]['bbox'], gt_annos[i]['alpha'][..., np.newaxis]], 1))
        dt_datas_list.append(np.concatenate(
            [dt_annos[i]['bbox'], dt_annos[i]['alpha'][..., np.newaxis],
             dt_annos[i]['score'][..., np.newaxis]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, np.array(total_dc_num), total_num_valid_gt)


def _compute_statistics_py(overlap, gt_data, dt_data, ignored_gt, ignored_det,
                           dontcare, metric, min_overlap, thresh=0.0,
                           compute_fp=False, compute_aos=False):
    """ctypes wrapper around the C++ single-frame statistics."""
    det_size = dt_data.shape[0]
    gt_size = gt_data.shape[0]
    stats = np.zeros(4, np.float64)
    thresholds = np.zeros(max(gt_size, 1), np.float64)
    nth = np.zeros(1, np.int64)
    _lib().compute_statistics(
        _dptr(_c(overlap)), det_size, gt_size,
        _dptr(_c(dt_data[:, -1])), _dptr(_c(dt_data[:, 4])),
        _dptr(_c(gt_data[:, 4])), _dptr(_c(dt_data[:, :4])),
        _dptr(_c(dontcare)), dontcare.shape[0],
        _iptr(_c(ignored_gt, np.int64)), _iptr(_c(ignored_det, np.int64)),
        metric, min_overlap, thresh, int(compute_fp), int(compute_aos),
        _dptr(stats), _dptr(thresholds), _iptr(nth))
    tp, fp, fn, similarity = stats
    return int(tp), int(fp), int(fn), similarity, thresholds[:nth[0]]


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """Parity: eval.py:450-552."""
    assert len(gt_annos) == len(dt_annos)
    overlaps, total_gt_num, total_dt_num = calculate_iou_partly(
        dt_annos, gt_annos, metric)
    N_SAMPLE_PTS = 41
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_dc_num, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty)
            # flat buffers for the fused C++ pass
            nf = len(gt_annos)
            gt_off = np.zeros(nf, np.int64)
            dt_off = np.zeros(nf, np.int64)
            dc_off = np.zeros(nf, np.int64)
            ov_off = np.zeros(nf, np.int64)
            g = d = c = o = 0
            for i in range(nf):
                gt_off[i], dt_off[i], dc_off[i], ov_off[i] = g, d, c, o
                g += total_gt_num[i]
                d += total_dt_num[i]
                c += total_dc_num[i]
                o += total_gt_num[i] * total_dt_num[i]
            gt_all = np.concatenate(gt_datas_list, 0) if g else np.zeros((0, 5))
            dt_all = np.concatenate(dt_datas_list, 0) if d else np.zeros((0, 6))
            dc_all = np.concatenate(dontcares, 0) if c else np.zeros((0, 4))
            ig_gt_all = np.concatenate(ignored_gts) if g else np.zeros(0, np.int64)
            ig_dt_all = np.concatenate(ignored_dets) if d else np.zeros(0, np.int64)
            ov_all = np.concatenate([ov.reshape(-1) for ov in overlaps]) \
                if o else np.zeros(0)

            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(nf):
                    _, _, _, _, th = _compute_statistics_py(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap, thresh=0.0, compute_fp=False)
                    thresholdss += th.tolist()
                thresholds = np.array(get_thresholds(
                    np.array(thresholdss), total_num_valid_gt))
                if len(thresholds) == 0:
                    continue
                pr = np.zeros([len(thresholds), 4], np.float64)
                _lib().fused_statistics(
                    _dptr(_c(ov_all)), _iptr(ov_off),
                    _iptr(_c(total_gt_num, np.int64)),
                    _iptr(_c(total_dt_num, np.int64)),
                    _iptr(_c(total_dc_num, np.int64)),
                    _iptr(gt_off), _iptr(dt_off), _iptr(dc_off),
                    _dptr(_c(dt_all[:, -1])), _dptr(_c(dt_all[:, 4])),
                    _dptr(_c(gt_all[:, 4])), _dptr(_c(dt_all[:, :4])),
                    _dptr(_c(dc_all)), _iptr(ig_gt_all), _iptr(ig_dt_all),
                    nf, metric, float(min_overlap),
                    _dptr(_c(thresholds)), len(thresholds),
                    int(compute_aos), _dptr(pr))
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:], axis=-1)
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, PR_detail_dict=None):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret['precision'])
    mAP_bbox_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['bbox'] = ret['precision']
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret['orientation'])
        mAP_aos_R40 = get_mAP_R40(ret['orientation'])
        if PR_detail_dict is not None:
            PR_detail_dict['aos'] = ret['orientation']
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps)
    mAP_bev = get_mAP(ret['precision'])
    mAP_bev_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['bev'] = ret['precision']
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps)
    mAP_3d = get_mAP(ret['precision'])
    mAP_3d_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['3d'] = ret['precision']
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, mAP_bbox_R40, mAP_bev_R40,
            mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             PR_detail_dict=None):
    """Parity: eval.py:639-721 (same min-overlap tables, same ret_dict keys)."""
    overlap_0_7 = np.array([
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.7]])
    overlap_0_5 = np.array([
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    class_to_name = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                     4: 'Person_sitting', 5: 'Truck'}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]
    result = ''
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break
    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                           compute_aos, PR_detail_dict=PR_detail_dict)

    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        cls = class_to_name[curcls]
        for i in range(min_overlaps.shape[0]):
            result += print_str(
                f'{cls} AP@{min_overlaps[0, 0, j]:.2f}, '
                f'{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:')
            result += print_str(
                f'bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, '
                f'{mAPbbox[j, 2, i]:.4f}')
            result += print_str(
                f'bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, '
                f'{mAPbev[j, 2, i]:.4f}')
            result += print_str(
                f'3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, '
                f'{mAP3d[j, 2, i]:.4f}')
            result += print_str(
                f'{cls} AP_R40@{min_overlaps[0, 0, j]:.2f}, '
                f'{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:')
            result += print_str(
                f'bbox AP:{mAPbbox_R40[j, 0, i]:.4f}, '
                f'{mAPbbox_R40[j, 1, i]:.4f}, {mAPbbox_R40[j, 2, i]:.4f}')
            result += print_str(
                f'bev  AP:{mAPbev_R40[j, 0, i]:.4f}, '
                f'{mAPbev_R40[j, 1, i]:.4f}, {mAPbev_R40[j, 2, i]:.4f}')
            result += print_str(
                f'3d   AP:{mAP3d_R40[j, 0, i]:.4f}, '
                f'{mAP3d_R40[j, 1, i]:.4f}, {mAP3d_R40[j, 2, i]:.4f}')
            if compute_aos:
                result += print_str(
                    f'aos  AP:{mAPaos_R40[j, 0, i]:.2f}, '
                    f'{mAPaos_R40[j, 1, i]:.2f}, {mAPaos_R40[j, 2, i]:.2f}')
                if i == 0:
                    ret_dict[f'{cls}_aos/easy_R40'] = mAPaos_R40[j, 0, 0]
                    ret_dict[f'{cls}_aos/moderate_R40'] = mAPaos_R40[j, 1, 0]
                    ret_dict[f'{cls}_aos/hard_R40'] = mAPaos_R40[j, 2, 0]
            if i == 0:
                ret_dict[f'{cls}_3d/easy_R40'] = mAP3d_R40[j, 0, 0]
                ret_dict[f'{cls}_3d/moderate_R40'] = mAP3d_R40[j, 1, 0]
                ret_dict[f'{cls}_3d/hard_R40'] = mAP3d_R40[j, 2, 0]
                ret_dict[f'{cls}_bev/easy_R40'] = mAPbev_R40[j, 0, 0]
                ret_dict[f'{cls}_bev/moderate_R40'] = mAPbev_R40[j, 1, 0]
                ret_dict[f'{cls}_bev/hard_R40'] = mAPbev_R40[j, 2, 0]
                ret_dict[f'{cls}_image/easy_R40'] = mAPbbox_R40[j, 0, 0]
                ret_dict[f'{cls}_image/moderate_R40'] = mAPbbox_R40[j, 1, 0]
                ret_dict[f'{cls}_image/hard_R40'] = mAPbbox_R40[j, 2, 0]
    return result, ret_dict
