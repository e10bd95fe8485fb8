"""Config system: YAML configs with ``_BASE_CONFIG_`` inheritance and dotted
CLI overrides.

Reference parity: ``pcdet/config.py:16-85`` (global EasyDict ``cfg``,
``merge_new_config`` with ``_BASE_CONFIG_``, ``cfg_from_list`` dotted
overrides).  Unlike the reference we avoid a process-global mutable config
where possible — ``load_config`` returns a fresh ``CfgNode`` — but we keep a
module-level ``cfg`` object for CLI-tool compatibility.
"""

from __future__ import annotations

import ast
import copy
from pathlib import Path

import yaml


class CfgNode(dict):
    """Attribute-style dict (replacement for easydict.EasyDict)."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    @staticmethod
    def _wrap(v):
        import collections.abc
        if isinstance(v, CfgNode):
            return v
        if isinstance(v, collections.abc.Mapping):
            return CfgNode(dict(v))
        if isinstance(v, (list, tuple)):
            return type(v)(CfgNode._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, CfgNode._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        del self[k]

    def __deepcopy__(self, memo):
        return CfgNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def clone(self):
        return copy.deepcopy(self)


def _resolve_base_path(base_path: str, cur_file=None) -> Path:
    """Resolve a _BASE_CONFIG_ include: as-is, relative to the including
    file, relative to the repo root, or relative to repo_root/tools (the
    reference resolves from the tools/ cwd)."""
    candidates = [Path(base_path)]
    if cur_file is not None:
        candidates.append(Path(cur_file).resolve().parent / base_path)
    root = Path(__file__).resolve().parent.parent
    candidates += [root / base_path, root / 'tools' / base_path]
    for cand in candidates:
        if cand.exists():
            return cand
    raise FileNotFoundError(f'_BASE_CONFIG_ not found: {base_path}')


def merge_new_config(config: CfgNode, new_config: dict, cur_file=None) -> CfgNode:
    """Recursively merge ``new_config`` into ``config``.

    Handles ``_BASE_CONFIG_`` includes the same way the reference does
    (`pcdet/config.py:51-68`): the base YAML is loaded first, then the
    current file's keys override it.
    """
    if '_BASE_CONFIG_' in new_config:
        base_path = _resolve_base_path(new_config['_BASE_CONFIG_'], cur_file)
        with open(base_path, 'r') as f:
            base_cfg = yaml.safe_load(f)
        merge_new_config(config, base_cfg, cur_file=base_path)

    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config[key], dict):
                config[key] = CfgNode()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def load_config(cfg_file: str | Path, config: CfgNode | None = None) -> CfgNode:
    """Load a YAML config (with base inheritance) into a CfgNode."""
    config = config if config is not None else CfgNode()
    with open(cfg_file, 'r') as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config, new_config, cur_file=cfg_file)
    config.TAG = Path(cfg_file).stem
    # EXP_GROUP_PATH mirrors pcdet: the cfg path relative to a 'cfgs' dir.
    parts = Path(cfg_file).resolve().parts
    if 'cfgs' in parts:
        idx = parts.index('cfgs')
        config.EXP_GROUP_PATH = '/'.join(parts[idx + 1:-1])
    else:
        config.EXP_GROUP_PATH = ''
    return config


def cfg_from_list(cfg_list, config: CfgNode):
    """Set config keys from a ['KEY.SUBKEY', 'value', ...] list.

    Mirrors ``pcdet/config.py:16-48`` including literal-eval type coercion and
    the ``key:subkey` syntax for in-list dict overrides.
    """
    assert len(cfg_list) % 2 == 0, 'override list must be key/value pairs'
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split('.')
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, f'NotFoundKey: {subkey}'
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f'NotFoundKey: {subkey}'
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if not isinstance(value, type(d[subkey])) and isinstance(d[subkey], CfgNode):
            # 'NAME:val' per-entry override inside a nested dict
            key_val_list = value.split(',')
            for src in key_val_list:
                cur_key, cur_val = src.split(':')
                assert cur_key in d[subkey], f'NotFoundKey: {cur_key}'
                d[subkey][cur_key] = ast.literal_eval(cur_val)
        elif isinstance(d[subkey], list) and not isinstance(value, list):
            d[subkey] = [type(d[subkey][0])(x) for x in str(value).split(',')]
        else:
            d[subkey] = CfgNode._wrap(value)
    return config


def log_config_to_file(config: CfgNode, pre='cfg', logger=None):
    for key, val in config.items():
        if isinstance(val, CfgNode):
            if logger:
                logger.info('----------- %s.%s -----------', pre, key)
            log_config_to_file(val, pre=f'{pre}.{key}', logger=logger)
        elif logger:
            logger.info('%s.%s: %s', pre, key, val)


def to_cfg(obj) -> 'CfgNode':
    """Coerce any Mapping (incl. flax FrozenDict — flax converts dict-typed
    module fields) back into an attribute-accessible CfgNode."""
    if isinstance(obj, CfgNode):
        return obj
    return CfgNode(dict(obj))


# Module-level cfg for CLI tools (mirrors pcdet's global `cfg`).
cfg = CfgNode()
cfg.LOCAL_RANK = 0
cfg.ROOT_DIR = Path(__file__).resolve().parent.parent
