"""Batch mastering farm on the PyTorch port.

Usage: python examples/torch_mastering_farm.py [t0 r0 t1 r1 ... ] [out_dir] [--device NAME]
(the PyTorch twin of examples/tpu_mastering_farm.py; it runs on the card
unless ``--device`` names another device)

No reference equivalent (the reference is single-process CPU).  Levels of
API:

1. ``mg.process_batch`` — the file-to-file call: decodes, conditions,
   bucket-pads, masters every pair (each track analyzed and limited at its
   true length), trims, encodes.  On one device the pairs run as
   pipelined independent graphs (``dispatch="pipelined"``); under a mesh
   one batched graph runs per row of the ``pairs`` axis.
2. The raw array path below it (``timeshard.master_farm``) for callers that
   manage their own I/O: a 2-D ``(pairs, time)`` mesh puts independent
   pairs on its rows and cuts each pair's time axis over its row's
   devices.
3. Several hosts: ``parallel.launch`` runs one process per host (or card)
   on ``torch.distributed``; each masters the pairs it owns.
"""

import os
import sys

import matchering_tpu_torch as mg

argv = sys.argv[1:]
device = None  # the card
if len(argv) >= 2 and argv[-2] == "--device":
    device, argv = argv[-1], argv[:-2]
out_dir = argv.pop() if len(argv) % 2 == 1 else "."
files = argv or [
    "song_a.wav", "ref_a.wav",
    "song_b.wav", "ref_b.wav",
    "song_c.wav", "ref_c.wav",
    "song_d.wav", "ref_d.wav",
]
pairs = list(zip(files[::2], files[1::2]))

# --- level 1: one call, files in and out -----------------------------------
jobs = [
    mg.PairJob(
        target=target,
        reference=reference,
        results=[mg.pcm16(os.path.join(out_dir, f"master_{i}.wav"))],
    )
    for i, (target, reference) in enumerate(pairs)
]
mg.process_batch(jobs, device=device)

# --- level 2: the same farm over a device mesh, arrays in hand ------------
# (uncomment on a host with several cards; there is no traffic between
# pairs, so the pairs axis scales with the cards)
#
# import numpy as np
# from matchering_tpu_torch.parallel import batch, make_mesh, timeshard
# config = mg.Config()
# tracks = [mg.check(*mg.load(t, "target"), config, "target")[0] for t, _ in pairs]
# refs = [mg.check(*mg.load(r, "reference"), config, "reference")[0] for _, r in pairs]
# targets_b, t_lengths = batch.bucket_pad(tracks)
# references_b, r_lengths = batch.bucket_pad(refs)
# mesh = make_mesh(pairs=2, time=2)
# out = timeshard.master_farm(targets_b, references_b, config, mesh=mesh,
#                             target_lengths=t_lengths, reference_lengths=r_lengths)
# for i in range(len(pairs)):
#     mg.save(f"master_{i}.wav", out.result[i, : t_lengths[i]].cpu().numpy(),
#             config.internal_sample_rate, "PCM_16")
#
# --- level 3: several hosts, one process each (torch.distributed) ---------
# (run under torchrun, or pass the coordinator, count and index)
#
# from matchering_tpu_torch.parallel import launch
# launch.initialize()                           # torchrun's environment
# mesh = launch.global_mesh()                   # (pairs, time) over all hosts
# start, stop = launch.local_pair_slice(mesh, len(pairs))
# owned = [mg.check(*mg.load(t, "target"), config, "target")[0] for t, _ in pairs[start:stop]]
# owned_refs = [mg.check(*mg.load(r, "reference"), config, "reference")[0] for _, r in pairs[start:stop]]
# bucket = launch.agree_bucket(max(len(t) for t in owned))
# targets_b, t_lengths = batch.bucket_pad(owned, bucket)
# references_b, r_lengths = batch.bucket_pad(owned_refs, launch.agree_bucket(max(len(r) for r in owned_refs)))
# out = launch.master_batch_distributed(targets_b, references_b, t_lengths, r_lengths, config, mesh)
# for row, result in launch.local_results(out):
#     mg.save(f"master_{row}.wav", result[: t_lengths[row - start]],
#             config.internal_sample_rate, "PCM_16")
# launch.shutdown()
