"""Training and validation on PyTorch (counterpart of
nerfactor_tpu/trainvali.py, same CLI and configs); the ported models are
NeRF (nerf.ini), the shape stage (shape.ini), the BRDF prior (brdf.ini)
and the joint NeRFactor model (nerfactor.ini):

  python -m nerfactor_tpu_torch.trainvali --config=nerf.ini \
      --config_override='data_root=...,outroot=...' [--debug] \
      [--device=cuda] [--profile_steps=N]

The config's ``scan_steps`` (8 in every shipped INI but brdf.ini) groups
that many batches into one call of ``make_train_step_scan``: on the card
one CUDA graph launch takes the group's steps (the first group runs
eagerly and the second captures the graph), on the CPU the plain loop;
the batches an epoch leaves over take one step each, and --debug forces
one step a call.

With --multihost it trains data parallel over rays (parallel/mesh.py),
one process a device, each feeding its local batch (global batch =
processes x n_rays_per_step): launched by torchrun,

  torchrun --nproc_per_node=N -m nerfactor_tpu_torch.trainvali \
      --multihost --config=...

or by hand with --coordinator=host:port --num_processes=N
--process_id=i in each process. Rank 0 alone writes the run directory
and validates while the others wait.

Writes, under <outroot>/<xname>/: checkpoints/ckpt-N.npz every
ckpt_period epochs ({'opt_state', 'params'} in JAX flatten order, so
either package resumes the other's), summary_{train,vali}/scalars.jsonl,
and every vali_period epochs vis_vali/epoch?????????/ with per-view images,
flipbooks, PSNR/SSIM and an HTML page. A run resumes from its latest
checkpoint. With the config's ``tensorboard`` on (the default) and
``torch.utils.tensorboard`` importable, TensorBoard event files go beside
each scalars.jsonl (``tensorboard --logdir <outroot>/<xname>``), with the
JAX package's tags and steps.
"""

import argparse
import json
import os
import queue
import shutil
import threading
from collections import deque
from os.path import join, dirname
from time import time

import numpy as np
import torch

from nerfactor_tpu_torch import datasets, models
from nerfactor_tpu_torch.parallel import mesh as meshlib
from nerfactor_tpu_torch.parallel.train import (
    build_optimizer, make_train_step, make_train_step_scan, make_eval_step)
from nerfactor_tpu_torch.utils import config as configutil, io as ioutil
from nerfactor_tpu_torch.utils.ckpt import CheckpointManager
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="trainvali")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--config', default='nerf.ini',
                   help="base .ini in the shipped config dir, or a path")
    p.add_argument('--config_override', default='',
                   help="e.g. 'key1=value1,key2=value2'")
    p.add_argument('--debug', action='store_true')
    p.add_argument('--device', default='cuda', help="torch device")
    p.add_argument('--profile_steps', type=int, default=0,
                   help="trace the first N train steps with torch.profiler "
                        "into <outdir>/profile (to the end of the scan_steps "
                        "group that reaches N)")
    p.add_argument('--multihost', action='store_true',
                   help="join a torch.distributed process group and train "
                        "data parallel over rays, one process a device: each "
                        "feeds its local batch (global batch = processes x "
                        "n_rays_per_step); rank 0 alone writes checkpoints, "
                        "summaries and vis. Reads torchrun's environment, or "
                        "the explicit --coordinator/--num_processes/"
                        "--process_id")
    p.add_argument('--coordinator', default=None,
                   help="with --multihost: rank 0's host:port, or an init "
                        "URL such as file:///shared/path")
    p.add_argument('--num_processes', type=int, default=None,
                   help="with --multihost: total process count")
    p.add_argument('--process_id', type=int, default=None,
                   help="with --multihost: this process's rank")
    p.add_argument('--timeout', type=float, default=meshlib.INIT_TIMEOUT_S,
                   help="with --multihost: seconds a rank waits to join the "
                        "group, and for each collective")
    return p.parse_args(argv)


def load_config(config_flag, override=''):
    parser = configutil.read_config(
        configutil.resolve_config_path(config_flag))
    configutil.apply_override(parser, override)
    return parser


class SummaryWriter:
    """Append-only JSONL scalar log, the canonical record, plus, when
    ``tensorboard`` is on and ``torch.utils.tensorboard`` imports,
    TensorBoard event files in the same directory with the JAX package's
    tags, steps and summary kinds: a scalar per key (the ``scalars``
    plugin's f32 tensor) and a string tensor of the ``text`` plugin. Where
    it does not import, a warning, and JSONL only (as the JAX package
    without TensorFlow)."""

    def __init__(self, path, tensorboard=True):
        self.path = path
        os.makedirs(dirname(path), exist_ok=True)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter as TbWriter
            except ImportError as exc:  # no tensorboard package
                logger.warn("TensorBoard writer unavailable (%s); writing "
                            "JSONL scalars only", exc)
            else:
                self._tb = TbWriter(dirname(path))

    def _write(self, rec):
        with open(self.path, 'a') as h:
            h.write(json.dumps(rec) + '\n')

    def scalars(self, step, **kv):
        rec = {'step': int(step)}
        rec.update({k: None if v is None else float(v)
                    for k, v in kv.items()})
        self._write(rec)
        if self._tb is not None:
            for k, v in rec.items():
                if k != 'step' and v is not None:
                    self._tb.add_scalar(k, v, int(step), new_style=True)

    def text(self, step, tag, value):
        self._write({'step': int(step), tag: value})
        if self._tb is not None:
            # As tf.summary.text: the tag as given (add_text would append
            # '/text_summary'), a scalar string tensor
            from tensorboard.compat.proto.summary_pb2 import (
                DATA_CLASS_TENSOR, Summary, SummaryMetadata)
            from tensorboard.compat.proto.tensor_pb2 import TensorProto
            from tensorboard.compat.proto.tensor_shape_pb2 import (
                TensorShapeProto)
            meta = SummaryMetadata(
                plugin_data=SummaryMetadata.PluginData(plugin_name='text'),
                data_class=DATA_CLASS_TENSOR)
            tensor = TensorProto(dtype='DT_STRING',
                                 string_val=[str(value).encode()],
                                 tensor_shape=TensorShapeProto())
            self._tb._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=tag, tensor=tensor,
                                             metadata=meta)]), int(step))

    def close(self):
        if self._tb is not None:
            self._tb.close()


def split_batch(dataset, batch):
    """A dataset batch -> (meta, f32/f16 numpy arrays for the device)."""
    arrays, meta = {}, {}
    for k, v in batch.items():
        if k in dataset.array_keys:
            v = np.asarray(v)
            arrays[k] = v.astype(np.float32) if v.dtype == np.float64 else v
        else:
            meta[k] = v
    return meta, arrays


def to_device(arrays, device):
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in arrays.items()}


def host_batches(dataset, datapipe, n_epochs=1, lookahead=3, group=1,
                 pin=False):
    """Iterator of (n_steps, metas, arrays, epoch_done) made by a
    background thread, which assembles the next ``lookahead`` items
    (pinned host tensors for a CUDA device) while the device trains on
    the current one. One producer spans ``n_epochs`` passes over
    ``datapipe``; the last item of each pass carries epoch_done=True. With
    ``group`` > 1 (the config's ``scan_steps``) a full group of batches
    travels stacked, each array with a leading axis of n_steps = group,
    for one ``make_train_step_scan`` call (the JAX package's ``_emit``);
    the batches an epoch leaves over travel one at a time (n_steps 1, the
    arrays as one step takes them)."""
    q = queue.Queue(maxsize=lookahead)
    stop = threading.Event()
    sentinel = object()
    err = []

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def emit(pend, stacked):
        if stacked:
            arrays = {k: np.stack([a[k] for _, a in pend])
                      for k in pend[0][1]}
        else:
            arrays = {k: np.ascontiguousarray(v)
                      for k, v in pend[0][1].items()}
        arrays = {k: torch.from_numpy(v) for k, v in arrays.items()}
        if pin:
            arrays = {k: v.pin_memory() for k, v in arrays.items()}
        return len(pend), [m for m, _ in pend], arrays

    def worker():
        try:
            for _ in range(n_epochs):
                pend, pending = [], None  # one-item lag tags the last
                for batch in datapipe:
                    pend.append(split_batch(dataset, batch))
                    if len(pend) == group:
                        item = emit(pend, group > 1)
                        pend = []
                        if pending is not None \
                                and not put(pending + (False,)):
                            return
                        pending = item
                for one in pend:  # the remainder: one step each
                    item = emit([one], False)
                    if pending is not None and not put(pending + (False,)):
                        return
                    pending = item
                if pending is None:
                    raise ValueError("Dataset is empty")
                if not put(pending + (True,)):
                    return
        except BaseException as e:  # re-raised on the consumer's side
            err.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)


def maintain_epoch_queue(epochs, new_epoch_dir):
    epochs.appendleft(new_epoch_dir)
    for epoch_dir in ioutil.sortglob(dirname(new_epoch_dir), '*'):
        if epoch_dir not in epochs:
            shutil.rmtree(epoch_dir)


def main(argv=None):
    """Trains; returns {'outdir', 'scan_steps', 'scan_groups': the calls of
    the multi-step dispatch, 'scan_captured': its CUDA graph's capture
    (seconds, pool bytes) or None}."""
    args = parse_args(argv)
    if args.debug:
        logger.warn("Debug mode: on")
    # The N-row heads and the render stay true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.multihost:
        return train(args, torch.device(args.device))
    device = meshlib.initialize(args.coordinator, args.num_processes,
                                args.process_id, device=args.device,
                                timeout_s=args.timeout)
    logger.info("Multi-process: rank %d of %d on %s", meshlib.rank(),
                meshlib.world(), device)
    try:
        return train(args, device, group=meshlib.group())
    finally:
        meshlib.shutdown()


def train(args, device, group=None):
    """The training loop on ``device``; with a process ``group``, this
    rank's part of it."""
    rank, world = (0, 1) if group is None else \
        (meshlib.rank(), meshlib.world())
    is_lead = group is None or meshlib.is_lead()

    def barrier():
        if group is not None:
            meshlib.barrier()

    parser = load_config(args.config, args.config_override)
    config = configutil.Config(parser)
    outdir = join(config.get('outroot'), configutil.get_xname(parser))
    if is_lead:
        ioutil.prepare_outdir(outdir,
                              overwrite=config.getboolean('overwrite'))
        logger.info("For results, see:\n\t%s", outdir)
        configutil.write_config(parser, outdir.rstrip('/') + '.ini')
    barrier()

    # Each rank's own seed samples its own rays (0 for one process)
    Dataset = datasets.get_dataset_class(config.get('dataset'))
    dataset_train = Dataset(config, 'train', debug=args.debug,
                            seed=rank)
    datapipe_train = dataset_train.build_pipeline()
    dataset_vali, datapipe_vali = None, None
    if is_lead:  # validation runs on rank 0 alone
        try:
            dataset_vali = Dataset(config, 'vali', debug=args.debug)
            datapipe_vali = dataset_vali.build_pipeline(
                no_shuffle=True, take=config.getint('vali_batches'))
        except FileNotFoundError:
            pass

    Model = models.get_model_class(config.get('model'))
    model = Model(config, debug=args.debug, device=device)
    seed = config.getint('seed', fallback=0) or 0
    params = model.init_params(torch.Generator().manual_seed(seed))
    optimizer = build_optimizer(config)
    # Moments and the step count beside the params, on the device
    opt_state = optimizer.init(params)

    ckptdir = join(outdir, 'checkpoints')
    keep_recent_epochs = config.getint('keep_recent_epochs', fallback=-1)
    max_to_keep = keep_recent_epochs if keep_recent_epochs > 0 else None
    ckptmanager = CheckpointManager(ckptdir, max_to_keep=max_to_keep)
    step_restored = ckptmanager.latest_step()
    if group is not None:  # every rank resumes from rank 0's latest ckpt-N
        step_restored = int(meshlib.replicate(torch.tensor(step_restored)))
    if step_restored > 0:
        state = ckptmanager.restore({'params': params,
                                     'opt_state': opt_state},
                                    step=step_restored)
        params, opt_state = state['params'], state['opt_state']
        logger.info("Resumed from epoch %d", step_restored)
    else:
        logger.info("Started from scratch")
    if group is not None:  # rank 0's parameters and optimizer state
        meshlib.replicate((params, opt_state))

    trainable_mask = model.trainable_mask(params) \
        if hasattr(model, 'trainable_mask') else None
    train_step = make_train_step(model, optimizer,
                                 trainable_mask=trainable_mask,
                                 group=group)
    # Multi-step dispatch: scan_steps stacked batches a call, one CUDA
    # graph launch on the card (the plain loop on the CPU); the batches an
    # epoch leaves over take one step each. 1 disables it, and --debug
    # forces 1 (it breaks after the first batch).
    scan_steps = 1 if args.debug else config.getint('scan_steps',
                                                     fallback=1)
    train_step_scan = make_train_step_scan(
        model, optimizer, trainable_mask=trainable_mask, n_steps=scan_steps,
        group=group) if scan_steps > 1 else None
    vali_step = make_eval_step(model, mode='vali')
    # The train draws (jitter, NeRF's samples and noise), on the device;
    # seeded alike on every rank, each keeping its rows of the global draw
    noise_gen = torch.Generator(device=device).manual_seed(seed + 1)

    # TensorBoard event files beside the JSONL (the JAX package's
    # ``tensorboard`` key, on by default); rank 0 alone writes
    writer_train, writer_vali = None, None
    if is_lead:
        write_tb = config.getboolean('tensorboard', fallback=True)
        writer_train = SummaryWriter(join(outdir, 'summary_train',
                                          'scalars.jsonl'),
                                     tensorboard=write_tb)
        writer_vali = SummaryWriter(join(outdir, 'summary_vali',
                                         'scalars.jsonl'),
                                    tensorboard=write_tb)
    vali_vis_epoch_dir = join(outdir, 'vis_vali', 'epoch{e:09d}')
    vali_epoch_deque = deque([], max_to_keep)

    epochs = config.getint('epochs')
    ckpt_period = config.getint('ckpt_period')
    vali_period = config.getint('vali_period')

    profiler = None
    profile_left = args.profile_steps if is_lead else 0
    if profile_left > 0:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        logger.info("Profiling %d steps", profile_left)

    def stop_profiler():
        profiler.stop()
        os.makedirs(join(outdir, 'profile'), exist_ok=True)
        profiler.export_chrome_trace(join(outdir, 'profile', 'trace.json'))
        logger.info("Profiler trace written")

    step = step_restored
    period_t0, period_batches = time(), 0
    scan_groups = 0
    # One producer across all epochs left (a resumed run numbers its
    # epochs from the checkpoint's, and its datapipe from 0, as JAX's);
    # debug mode breaks mid-epoch, so it gets one producer per epoch
    batches = None
    if not args.debug and epochs > step_restored:
        batches = host_batches(dataset_train, datapipe_train,
                               n_epochs=epochs - step_restored,
                               group=scan_steps,
                               pin=device.type == 'cuda')
    for _ in range(step_restored, epochs):
        # Losses stay on the device; one readback per epoch
        batch_loss, n_batches = [], 0
        epoch_iter = batches if batches is not None else host_batches(
            dataset_train, datapipe_train, group=scan_steps)
        for n_steps, _, arrays, epoch_done in epoch_iter:
            if n_steps > 1:
                params, opt_state, losses = train_step_scan(
                    params, opt_state, arrays, generator=noise_gen)
                loss = losses[-1]
                scan_groups += 1
            else:
                params, opt_state, loss = train_step(
                    params, opt_state, to_device(arrays, device),
                    generator=noise_gen)
                losses = loss.reshape(1)
            batch_loss.append(losses)
            n_batches += n_steps
            if profiler is not None and profile_left > 0:
                profile_left -= n_steps
                if profile_left <= 0:
                    stop_profiler()
            if args.debug:
                if not torch.isfinite(loss):
                    raise FloatingPointError(
                        "Loss went non-finite: %r" % float(loss))
                logger.warn("Debug mode: skipping the rest of this epoch")
                break
            if epoch_done:
                break
        if not n_batches:
            raise ValueError("Dataset is empty")
        last_loss = float(batch_loss[-1][-1])
        if not np.isfinite(last_loss):
            raise FloatingPointError("Loss went non-finite at epoch %d: %r"
                                     % (step + 1, last_loss))
        step += 1
        period_batches += n_batches

        if step % ckpt_period == 0:
            if is_lead:
                # The losses are the global batch's means already
                losses = torch.cat(batch_loss).cpu().numpy()
                elapsed = time() - period_t0
                saved = ckptmanager.save(step, {'params': params,
                                                'opt_state': opt_state})
                logger.info("Checkpointed epoch %d:\n\t%s", step, saved)
                writer_train.scalars(
                    step, loss_train=np.mean(losses),
                    batch_time_train=elapsed / max(period_batches, 1),
                    rays_per_sec=world * dataset_train.bs
                    * period_batches / elapsed)
            barrier()
            period_t0, period_batches = time(), 0

        vali_now = vali_period > 0 and step % vali_period == 0
        if datapipe_vali is not None and vali_now:
            vali_loss, vis_dirs = [], []
            epoch_dir = vali_vis_epoch_dir.format(e=step)
            for batch_i, batch in enumerate(datapipe_vali):
                meta, arrays = split_batch(dataset_vali, batch)
                loss, to_vis = vali_step(params, to_device(arrays, device))
                vali_loss.append(float(loss))
                to_vis_np = {k: v.cpu().numpy() for k, v in to_vis.items()}
                to_vis_np.update(meta)
                vis_dir = join(epoch_dir, 'batch{b:09d}'.format(b=batch_i))
                model.vis_batch(to_vis_np, vis_dir, mode='vali')
                vis_dirs.append(vis_dir)
            writer_vali.scalars(step, loss_vali=np.mean(vali_loss))
            view_at = model.compile_batch_vis(vis_dirs, join(epoch_dir, 'all'),
                                              mode='vali')
            if view_at is not None:
                writer_vali.text(step, 'vis_vali', view_at)
            maintain_epoch_queue(vali_epoch_deque, epoch_dir)
        if vali_now:
            barrier()

    if profiler is not None and profile_left > 0:
        stop_profiler()
    if is_lead:
        writer_train.close()
        writer_vali.close()
    logger.info("Training done (%d epochs)", epochs)
    return {'outdir': outdir, 'scan_steps': scan_steps,
            'scan_groups': scan_groups, 'scan_captured': None
            if train_step_scan is None else train_step_scan.captured}


if __name__ == '__main__':
    main()
