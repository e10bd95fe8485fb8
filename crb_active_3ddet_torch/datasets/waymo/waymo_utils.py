"""Waymo tfrecord preprocessing: frame → per-frame .npy points + info dicts.

Copy of ``crb_active_3ddet_tpu/datasets/waymo/waymo_utils.py`` (parity:
``pcdet/datasets/waymo/waymo_utils.py`` generate_labels :23,
convert_range_image_to_point_cloud :64, save_lidar_points :160,
process_single_sequence :184).  It needs the ``waymo-open-dataset`` package
and its TensorFlow, which are imported inside a ``try``: without them every
function here raises ``ImportError`` (``_require_waymo``), and the rest of the
Waymo path (training and eval from the preprocessed artifacts) works as it
is.  The conversion uses the official ``frame_utils`` helpers, then flattens
to the (N, 6) [x, y, z, intensity, elongation, NLZ] float32 layout that the
reference writes, so preprocessed data is interchangeable between the two
packages.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

# waymo-open-dataset before tensorflow: where the first is missing the import
# fails at once, without loading TensorFlow into the process
try:  # pragma: no cover - needs waymo-open-dataset
    from waymo_open_dataset import dataset_pb2
    from waymo_open_dataset.utils import frame_utils
    import tensorflow as tf
    _WAYMO_OK = True
except Exception:  # pragma: no cover
    tf = None
    dataset_pb2 = None
    frame_utils = None
    _WAYMO_OK = False

WAYMO_CLASSES = ['unknown', 'Vehicle', 'Pedestrian', 'Sign', 'Cyclist']


def _require_waymo():
    if not _WAYMO_OK:
        raise ImportError(
            'waymo-open-dataset (and tensorflow) are required for tfrecord '
            'preprocessing: pip install waymo-open-dataset-tf-2-*')


def generate_labels(frame):
    """Laser labels → annotation dict with gt_boxes_lidar (N, 7) [x y z l w h
    heading] in the unified lidar frame (same fields as the reference)."""
    _require_waymo()
    names, difficulty, tracking_difficulty = [], [], []
    dims, locs, headings, obj_ids, num_points = [], [], [], [], []
    for lab in frame.laser_labels:
        box = lab.box
        names.append(WAYMO_CLASSES[lab.type])
        difficulty.append(lab.detection_difficulty_level)
        tracking_difficulty.append(lab.tracking_difficulty_level)
        dims.append([box.length, box.width, box.height])
        locs.append([box.center_x, box.center_y, box.center_z])
        headings.append(box.heading)
        obj_ids.append(lab.id)
        num_points.append(lab.num_lidar_points_in_box)

    annos = {
        'name': np.array(names),
        'difficulty': np.array(difficulty),
        'dimensions': np.array(dims).reshape(-1, 3),
        'location': np.array(locs).reshape(-1, 3),
        'heading_angles': np.array(headings),
        'obj_ids': np.array(obj_ids),
        'tracking_difficulty': np.array(tracking_difficulty),
        'num_points_in_gt': np.array(num_points),
    }
    keep = annos['name'] != 'unknown'
    annos = {k: v[keep] for k, v in annos.items()}
    if len(annos['name']):
        annos['gt_boxes_lidar'] = np.concatenate(
            [annos['location'], annos['dimensions'],
             annos['heading_angles'][:, None]], axis=1)
    else:
        annos['gt_boxes_lidar'] = np.zeros((0, 7))
    return annos


def save_lidar_points(frame, save_path, use_two_returns=True):
    """All-lidar point cloud → (N, 6) [x y z intensity elongation nlz] .npy.
    Returns points-per-lidar counts (first return)."""
    _require_waymo()
    parsed = frame_utils.parse_range_image_and_camera_projection(frame)
    if len(parsed) == 4:  # newer waymo-open-dataset also returns seg labels
        range_images, camera_projections, _, range_image_top_pose = parsed
    else:
        range_images, camera_projections, range_image_top_pose = parsed

    ri_indices = (0, 1) if use_two_returns else (0,)
    points_all, intensity_all, elongation_all, nlz_all = [], [], [], []
    num_points_of_each_lidar = None
    for ri in ri_indices:
        points, _ = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose,
            ri_index=ri, keep_polar_features=True)
        # keep_polar_features → per-lidar (N, 6): range, intensity,
        # elongation, x, y, z
        if ri == 0:
            num_points_of_each_lidar = [len(p) for p in points]
        for p in points:
            points_all.append(p[:, 3:6])
            intensity_all.append(p[:, 1])
            elongation_all.append(p[:, 2])
        # NLZ mask per lidar from the raw range image channel 3
        for c in sorted(range_images.keys()):
            ri_tensor = tf.convert_to_tensor(range_images[c][ri].data)
            ri_tensor = tf.reshape(
                ri_tensor, range_images[c][ri].shape.dims).numpy()
            mask = ri_tensor[..., 0] > 0
            nlz_all.append(ri_tensor[..., 3][mask])

    xyz = np.concatenate(points_all, axis=0).astype(np.float32)
    intensity = np.concatenate(intensity_all)[:, None].astype(np.float32)
    elongation = np.concatenate(elongation_all)[:, None].astype(np.float32)
    nlz = np.concatenate(nlz_all)[:len(xyz)][:, None].astype(np.float32) \
        if nlz_all else np.full((len(xyz), 1), -1, np.float32)
    if len(nlz) != len(xyz):  # channel bookkeeping mismatch → no-NLZ marker
        nlz = np.full((len(xyz), 1), -1, np.float32)
    out = np.concatenate([xyz, intensity, elongation, nlz], axis=1)
    np.save(save_path, out)
    return num_points_of_each_lidar


def process_single_sequence(sequence_file, save_path, sampled_interval,
                            has_label=True, use_two_returns=True):
    """One .tfrecord → per-frame .npy + a <seq>.pkl info list (idempotent:
    skips sequences whose pkl already exists, like the reference)."""
    _require_waymo()
    sequence_file = Path(sequence_file)
    sequence_name = sequence_file.stem
    if not sequence_file.exists():
        print(f'NotFoundError: {sequence_file}')
        return []

    cur_save_dir = Path(save_path) / sequence_name
    cur_save_dir.mkdir(parents=True, exist_ok=True)
    pkl_file = cur_save_dir / f'{sequence_name}.pkl'
    if pkl_file.exists():
        with open(pkl_file, 'rb') as f:
            return pickle.load(f)

    dataset = tf.data.TFRecordDataset(str(sequence_file), compression_type='')
    sequence_infos = []
    for cnt, data in enumerate(dataset):
        if cnt % sampled_interval != 0:
            continue
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))

        info = {
            'point_cloud': {'num_features': 5,
                            'lidar_sequence': sequence_name,
                            'sample_idx': cnt},
            'frame_id': sequence_name + ('_%03d' % cnt),
            'metadata': {'context_name': frame.context.name,
                         'timestamp_micros': frame.timestamp_micros},
            'image': {f'image_shape_{j}': (
                frame.context.camera_calibrations[j].height,
                frame.context.camera_calibrations[j].width)
                for j in range(len(frame.context.camera_calibrations))},
            'pose': np.array(frame.pose.transform,
                             dtype=np.float32).reshape(4, 4),
        }
        if has_label:
            info['annos'] = generate_labels(frame)
        info['num_points_of_each_lidar'] = save_lidar_points(
            frame, cur_save_dir / ('%04d.npy' % cnt),
            use_two_returns=use_two_returns)
        sequence_infos.append(info)

    with open(pkl_file, 'wb') as f:
        pickle.dump(sequence_infos, f)
    print(f'Infos saved (sampled_interval={sampled_interval}): {pkl_file}')
    return sequence_infos
