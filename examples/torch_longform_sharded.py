"""Long-form master on the PyTorch port with the time axis sharded over
devices.

Usage: python examples/torch_longform_sharded.py [target] [reference] [output] [--device NAME]
(the PyTorch twin of examples/tpu_longform_sharded.py)

The reference rejects tracks over 15 minutes (``matchering/checker.py:95``);
here a 60-minute 96 kHz master runs with its time axis cut into one shard
per visible card — halo copies and carried IIR scans keep the output equal
to the single-device result.  ``--device NAME`` puts two shards on that one
device instead (a device may hold several shards: ``--device cpu`` runs
without a card).
"""

import sys
import tempfile

import numpy as np

import matchering_tpu_torch as mg
from matchering_tpu_torch.io import load
from matchering_tpu_torch.parallel import mesh, timeshard

argv = sys.argv[1:]
device = None  # every visible card, one shard each
if len(argv) >= 2 and argv[-2] == "--device":
    device, argv = argv[-1], argv[:-2]
target_file, reference_file, output_file = (
    argv[:3] if len(argv) >= 3 else ("my_one_hour_set.wav", "some_popular_song.wav", "my_one_hour_master.wav")
)

config = mg.Config(
    internal_sample_rate=96000,
    max_length=60 * 60,  # allow one hour
)
shards = mesh.single_axis_mesh("time", devices=None if device is None else [device] * 2)
home = shards.along("time")[0]

target, t_sr = load(target_file, "target", tempfile.gettempdir())
reference, r_sr = load(reference_file, "reference", tempfile.gettempdir())
target, _ = mg.check(target, t_sr, config, "target", device=home)
reference, _ = mg.check(reference, r_sr, config, "reference", device=home)

out = timeshard.master_sharded(target, reference, config, mesh=shards)
mg.save(output_file, np.asarray(out.result.cpu()), 96000, "PCM_24")
