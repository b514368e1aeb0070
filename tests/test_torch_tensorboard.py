"""TensorBoard event files of the PyTorch port's trainvali vs the JAX
package's (CPU): both packages train brdf.ini at a tiny size (16 x 2
MLP, 3 synthetic materials, 3 epochs, a checkpoint a epoch, vali at the
last) and write event files beside summary_{train,vali}/scalars.jsonl.
Read back with tensorboard's event reader:

  * the (tag, step, plugin) triples of each summary directory equal the
    JAX package's;
  * every value equals the package's own JSONL (scalars as the f32 the
    event stores, text as the string).

The JAX half needs TensorFlow (its writer) and skips where TF does not
import. Also: ``tensorboard=False`` writes JSONL only, and so does a
writer where torch.utils.tensorboard does not import.
"""

import glob
import json
import os
import sys
from os.path import join

import numpy as np
import pytest

from nerfactor_tpu_torch import trainvali as ttrainvali
from nerfactor_tpu_torch.brdf import merl as tmerl
from nerfactor_tpu_torch.brdf.renderer import SphereRenderer

MATERIALS = ('alum-bronze', 'pearl-paint', 'red-plastic')
ENVMAP_H, IMS = 4, 8


def write_tables(root):
    """train_/vali_<name>.npz per material and the shared test.npz, in
    the MERL converter's format."""
    os.makedirs(root)
    rng = np.random.RandomState(0)
    common = {'envmap_h': ENVMAP_H, 'ims': IMS, 'spp': 1}
    for i, name in enumerate(MATERIALS):
        rusink = (rng.rand(300, 3) * [np.pi, np.pi / 2, np.pi / 2]).astype(
            np.float32)
        refl = (0.02 + rng.rand(300, 1) * (i + 1)).astype(np.float32)
        for mode, rows in (('train', slice(0, 256)), ('vali', slice(256, 300))):
            np.savez(join(root, '%s_%s.npz' % (mode, name)), i=i, name=name,
                     rusink=rusink[rows], refl=refl[rows], **common)
    ren = SphereRenderer('point', None, envmap_h=ENVMAP_H, envmap_inten=40,
                         ims=IMS)
    render = tmerl.dir2rusink(ren.ldir, ren.vdir)[ren.lvis.astype(bool)]
    np.savez(join(root, 'test.npz'), rusink=np.vstack((
        tmerl.characteristic_slice_rusink().reshape(-1, 3),
        render)).astype(np.float32), **common)


def override(tables, outroot, extra=''):
    return ','.join(['data_root=' + tables, 'outroot=' + outroot,
                     'mlp_width=16', 'mlp_depth=2', 'mlp_skip_at=1',
                     'n_rays_per_step=64', 'epochs=3', 'ckpt_period=1',
                     'vali_period=3', 'vali_batches=1']
                    + ([extra] if extra else []))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tb'))
    tables = join(root, 'tables')
    write_tables(tables)
    out = {'root': root, 'tables': tables}
    out['port'] = ttrainvali.main([
        '--config', 'brdf.ini', '--device', 'cpu', '--config_override',
        override(tables, join(root, 'port'))])['outdir']
    return out


def events(summary_dir):
    """[(tag, step, plugin, value)] of the event files in a directory:
    a float for a scalar, a str for text."""
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util import tensor_util
    paths = glob.glob(join(summary_dir, 'events.out.tfevents.*'))
    assert paths, 'no event file in %s' % summary_dir
    out = []
    for path in paths:
        for ev in EventFileLoader(path).Load():
            for v in ev.summary.value:
                val = tensor_util.make_ndarray(v.tensor)
                plugin = v.metadata.plugin_data.plugin_name
                val = val.item().decode() if plugin == 'text' \
                    else float(val)
                out.append((v.tag, int(ev.step), plugin, val))
    return sorted(out)


def jsonl(summary_dir):
    with open(join(summary_dir, 'scalars.jsonl')) as h:
        return [json.loads(line) for line in h]


def assert_events_match_jsonl(summary_dir):
    """Every event's value is the JSONL record's at its step and key (a
    scalar as its f32), and every JSONL value has its event."""
    evs = events(summary_dir)
    want = []
    for rec in jsonl(summary_dir):
        for k, v in rec.items():
            if k == 'step' or v is None:
                continue
            if isinstance(v, str):
                want.append((k, rec['step'], 'text', v))
            else:
                want.append((k, rec['step'], 'scalars',
                             float(np.float32(v))))
    assert evs == sorted(want)
    return evs


def test_port_events_equal_jsonl(runs):
    tags = {}
    for sub in ('summary_train', 'summary_vali'):
        evs = assert_events_match_jsonl(join(runs['port'], sub))
        tags[sub] = sorted({(t, s) for t, s, _, _ in evs})
    assert tags['summary_train'] == [
        (k, s) for k in ('batch_time_train', 'loss_train', 'rays_per_sec')
        for s in (1, 2, 3)]
    assert tags['summary_vali'] == [('loss_vali', 3), ('vis_vali', 3)]


def test_event_tags_and_steps_match_jax(runs):
    pytest.importorskip('tensorflow')
    from nerfactor_tpu import trainvali as jtrainvali
    jdir = jtrainvali.main([
        '--config', 'brdf.ini', '--config_override',
        override(runs['tables'], join(runs['root'], 'jax'))])
    jdir = join(runs['root'], 'jax', os.path.basename(runs['port']))
    for sub in ('summary_train', 'summary_vali'):
        got = assert_events_match_jsonl(join(runs['port'], sub))
        want = assert_events_match_jsonl(join(jdir, sub))
        assert [e[:3] for e in got] == [e[:3] for e in want], sub


def test_tensorboard_off_writes_jsonl_only(runs):
    outdir = ttrainvali.main([
        '--config', 'brdf.ini', '--device', 'cpu', '--config_override',
        override(runs['tables'], join(runs['root'], 'off'),
                 'tensorboard=False,epochs=1,vali_period=0')])['outdir']
    assert os.listdir(join(outdir, 'summary_train')) == ['scalars.jsonl']
    assert len(jsonl(join(outdir, 'summary_train'))) == 1


def test_writer_without_tensorboard_warns(tmp_path, monkeypatch, capsys):
    """Where torch.utils.tensorboard does not import: a warning, and the
    JSONL alone."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    writer = ttrainvali.SummaryWriter(str(tmp_path / 'scalars.jsonl'))
    writer.scalars(1, loss=0.5)
    writer.text(1, 'vis', 'page.html')
    writer.close()
    assert 'TensorBoard writer unavailable' in capsys.readouterr().err
    assert os.listdir(str(tmp_path)) == ['scalars.jsonl']
    assert jsonl(str(tmp_path)) == [{'step': 1, 'loss': 0.5},
                                    {'step': 1, 'vis': 'page.html'}]
