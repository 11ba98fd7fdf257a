"""The port's entry points (``ray_tpu_torch.entry``) vs the JAX package's
(``__graft_entry__``).

``entry()``'s heartbeat step on its example problem (64 x 8 x 8 x 512,
seed 0) gives the reference step's counts and new_avail bit for bit;
``dryrun_multichip`` passes on 4 and 8 CPU ranks and prints its stamp,
and without a device it needs that many cards."""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from ray_tpu_torch import entry


def test_entry_step_equals_the_reference_step():
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args[:-1])
    counts, new_avail = fn(*args)
    ref_fn, ref_args = ref_entry.entry()
    want_counts, want_avail = ref_fn(*ref_args)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(new_avail.numpy(), np.asarray(want_avail))
    for a, b in zip(args[:-1], ref_args[:-1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert args[-1] == int(ref_args[-1])
    assert int(counts.sum()) == 512


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_ranks(n, capsys):
    info = entry.dryrun_multichip(n, device="cpu")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("DRYRUN_PLATFORM: ")]
    assert len(line) == 1
    assert json.loads(line[0].split(": ", 1)[1]) == info
    assert info["platform"] == "cpu" and info["n_devices"] == n
    assert info["cards"] == 0 and info["two_level_mesh"]
    assert info["checks"] == ["sharded_waterfill_vs_oracle", "psum_sync",
                              "ring_attention_sp_train_step",
                              "two_level_dcn_sync", "two_level_waterfill"]


def test_dryrun_multichip_needs_cards_without_a_device():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA cards"):
        entry.dryrun_multichip(have + 1)
