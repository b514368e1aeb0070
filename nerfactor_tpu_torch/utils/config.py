"""INI config system with CLI parity to the reference (copy of
nerfactor_tpu/utils/config.py, so the port runs without the JAX package).

Same contracts as nerfactor/util/config.py:
  * configs are .ini files with only a DEFAULT section;
  * ``'k1=v1,k2=v2'`` overrides merge on top;
  * the experiment name ``xname`` is a template over config values;
  * a checkpoint path implies its config at '<two dirs up>.ini'.
"""

import os
from configparser import ConfigParser


def read_config(path):
    config = ConfigParser()
    with open(path, 'r') as h:
        config.read_file(h)
    return config


def write_config(config, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as h:
        config.write(h)


def apply_override(config, override_str):
    """Merges 'k1=v1,k2=v2' into the DEFAULT section."""
    if not override_str:
        return config
    for kv in override_str.split(','):
        k, v = kv.split('=')
        config.set('DEFAULT', k, v)
    return config


def config2dict(config):
    return dict(config.items('DEFAULT'))


def get_xname(config):
    """The experiment name: the config's ``xname`` template filled in
    with its own values (e.g. 'lr{lr}' -> 'lr5e-3')."""
    return config.get('DEFAULT', 'xname').format(**config2dict(config))


# The shipped configs: the port's own copy of the JAX package's INIs
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'config')


def resolve_config_path(name_or_path):
    """A bare name like 'nerfactor.ini' resolves into the shipped config
    directory."""
    if os.path.exists(name_or_path):
        return name_or_path
    return os.path.join(CONFIG_DIR, name_or_path)


def get_config_ini(ckpt_path):
    """Derives the experiment .ini from a checkpoint path by convention:
    <outroot>/<xname>/checkpoints/ckpt-N -> <outroot>/<xname>.ini."""
    return '/'.join(ckpt_path.split('/')[:-2]) + '.ini'


class Config:
    """Typed view over a ConfigParser DEFAULT section, so models read
    ``cfg.getint('mlp_width')`` without repeating the section name."""

    def __init__(self, parser):
        self.parser = parser

    def get(self, key, fallback=None):
        return self.parser.get('DEFAULT', key, fallback=fallback)

    def getint(self, key, fallback=None):
        return self.parser.getint('DEFAULT', key, fallback=fallback)

    def getfloat(self, key, fallback=None):
        return self.parser.getfloat('DEFAULT', key, fallback=fallback)

    def getboolean(self, key, fallback=None):
        return self.parser.getboolean('DEFAULT', key, fallback=fallback)

    def has(self, key):
        return self.parser.has_option('DEFAULT', key)
