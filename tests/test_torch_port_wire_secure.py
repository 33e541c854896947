"""The port's wire-plane secure aggregation against the JAX package's, on
the CPU at small sizes (``tests/test_comm.py``'s tiny MLP).

- The protocol values are byte-equal to JAX's for the same inputs: the
  DH shared secret and the rejection of degenerate keys, the Shamir
  shares (the same polynomial coefficients drawn) and their
  reconstruction, the share cipher, the self-mask commitment, and the
  pair and self-mask keys (the port seeds its streams with JAX's 64 key
  bits less the lowest).
- The masks are the port's own draws: the masks of a port federation
  cancel, DH (complete graph and ring) and shared seed, giving the
  unmasked federation's params to 2e-4, JAX's own bound in
  ``tests/test_comm.py`` (the f32 cancellation noise of masks of std 1,
  carried through a second round of training, and the masked sum's
  uniform weights against the plain mean's example weights).
- Dropout recovery: a cohort member that dies before the round, or whose
  train reply is dropped after the share phase (a FaultPlan), leaves the
  survivors' plain aggregate (to 2e-4), with JAX's records.
- The coordinator cannot unmask: the experiment seed's masks recover
  nothing of a masked DH update, while the pair member's key recovers it
  (as JAX's ``test_coordinator_view_cannot_unmask_dh``).
- A round whose shares cannot be collected is discarded
  (``unmask_failed``), as in JAX.
"""

import json
import secrets

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.comm import keyexchange as jax_kx
from colearn_federated_learning_tpu.comm import worker as jax_worker
from colearn_federated_learning_tpu import faults as jax_faults
from colearn_federated_learning_tpu.privacy import dropout as jax_dropout
from colearn_federated_learning_tpu_torch import faults
from colearn_federated_learning_tpu_torch.comm import keyexchange
from colearn_federated_learning_tpu_torch.comm.broker import BrokerClient
from colearn_federated_learning_tpu_torch.comm.enrollment import (
    fetch_device_info)
from colearn_federated_learning_tpu_torch.comm.transport import TensorClient
from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
from colearn_federated_learning_tpu_torch.fed import programs
from colearn_federated_learning_tpu_torch.privacy import dropout
from colearn_federated_learning_tpu_torch.privacy import secure_agg as sa
from colearn_federated_learning_tpu_torch.utils import trees
from test_torch_port_socket import (
    WAIT, Federation, assert_records_match, configs, jax_init, params_of)

CANCEL_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PORT_DRAWS = {"draws": None}     # the port's own draws (masks, ring)


# ------------------------------------------------------- protocol values --
def _jax_key_seed(words) -> int:
    """The port's stream seed of a JAX uint32[2] key."""
    return int.from_bytes(np.asarray(words).astype(">u4").tobytes(),
                          "big") >> 1


def test_dh_values_are_jax_values():
    a_priv, a_pub = keyexchange.generate_keypair()
    b_priv, b_pub = jax_kx.generate_keypair()
    ours = keyexchange.shared_secret(a_priv, b_pub)
    assert ours == jax_kx.shared_secret(a_priv, b_pub)
    assert ours == jax_kx.shared_secret(b_priv, a_pub)
    assert keyexchange.encode_public(a_pub) == jax_kx.encode_public(a_pub)
    assert keyexchange.pair_prng_key(ours, 3, 1) == _jax_key_seed(
        jax_kx.pair_prng_key(ours, 1, 3))
    for bad in (0, 1, keyexchange.GROUP14_P - 1, keyexchange.GROUP14_P):
        with pytest.raises(keyexchange.InvalidPublicKeyError) as ours_e:
            keyexchange.validate_public(bad)
        with pytest.raises(jax_kx.InvalidPublicKeyError) as theirs_e:
            jax_kx.validate_public(bad)
        assert ours_e.value.reason == theirs_e.value.reason


def test_recovery_values_are_jax_values(monkeypatch):
    for n in range(0, 9):
        for frac in (0.1, 0.5, 2 / 3, 1.0):
            assert dropout.threshold_count(n, frac) == \
                jax_dropout.threshold_count(n, frac)
    secret = dropout.random_secret()
    xs = [2, 5, 7, 9]
    coeffs = [secrets.randbelow(dropout.PRIME) for _ in range(2)]

    def fixed(bound):
        return coeffs[fixed.i % len(coeffs)] % bound

    split = {}
    for mod in (dropout, jax_dropout):
        fixed.i = 0
        monkeypatch.setattr(secrets, "randbelow", lambda b: (
            fixed(b), setattr(fixed, "i", fixed.i + 1))[0])
        split[mod] = mod.split_secret(secret, xs, 3)
    monkeypatch.undo()
    assert split[dropout] == split[jax_dropout]
    some = {x: split[dropout][x] for x in (9, 2, 7)}
    assert dropout.reconstruct(some, 3) == jax_dropout.reconstruct(some, 3) \
        == secret
    with pytest.raises(dropout.RecoveryError):
        dropout.reconstruct({2: 1}, 3)
    pair = secrets.token_bytes(32)
    s_share, b_share = split[dropout][2], split[dropout][5]
    blob = dropout.encrypt_share(pair, 4, 1, 7, s_share, b_share)
    assert blob == jax_dropout.encrypt_share(pair, 4, 1, 7, s_share, b_share)
    assert dropout.decrypt_share(pair, 4, 1, 7, blob) == (s_share, b_share)
    assert dropout.commitment(secret) == jax_dropout.commitment(secret)
    assert dropout.self_mask_key(secret) == _jax_key_seed(
        jax_dropout.self_mask_key(secret))


def test_mask_streams_cancel_and_are_keyed_by_round():
    keys = [11, 12]
    a = sa.pairwise_mask_with_keys(64, keys, [1.0, -1.0], 3, "cpu")
    b = sa.pairwise_mask_with_keys(64, keys, [-1.0, 1.0], 3, "cpu")
    assert torch.equal(a, -b)
    assert not torch.equal(sa.pair_stream(11, 3, 64, "cpu"),
                           sa.pair_stream(11, 4, 64, "cpu"))
    flat = torch.arange(64, dtype=torch.float32)
    assert torch.equal(sa.mask_update_with_keys(flat, keys, [1.0, -1.0], 3),
                       flat + a)


# ------------------------------------------------------------ federations --
def _final(cfgs, n, rounds=2, setup=None, round_timeout=30.0):
    with Federation(cfgs, n, want_evaluator=False,
                    round_timeout=round_timeout, worker_kw=PORT_DRAWS) as f:
        recs = []
        for r in range(rounds):
            if setup is not None:
                setup(f, r)
            recs.append(f.coord.run_round())
        return recs, params_of(f.coord)


def _assert_cancel(masked, plain):
    for k in plain:
        np.testing.assert_allclose(masked[k], plain[k], rtol=0,
                                   atol=CANCEL_ATOL, err_msg=k)


@pytest.mark.parametrize("n,fed_kw", [
    (3, dict()), (4, dict(secure_agg_neighbors=2)),
    (3, dict(secure_agg_key_exchange="shared_seed"))])
def test_masks_cancel(n, fed_kw):
    recs, masked = _final(configs(num_clients=n, secure_agg=True, **fed_kw), n)
    assert all(r["completed"] == n and not r["unmask_failed"] for r in recs)
    assert all(np.isnan(r["train_loss"]) for r in recs)
    _, plain = _final(configs(num_clients=n), n)
    _assert_cancel(masked, plain)


def _kill_2(f, r):
    if r == 1:
        f.workers[2].stop()
        f.coord.round_timeout = 3.0


@pytest.mark.parametrize("exchange", ["dh", "shared_seed"])
def test_dropout_recovery_gives_the_survivors_plain_sum(exchange):
    recs, masked = _final(configs(num_clients=3, secure_agg=True,
                                  secure_agg_key_exchange=exchange), 3,
                          setup=_kill_2)
    assert recs[1]["dropped"] == ["2"] and recs[1]["completed"] == 2
    assert not recs[1]["unmask_failed"]
    _, plain = _final(configs(num_clients=3), 3, setup=_kill_2)
    _assert_cancel(masked, plain)


DROP_TRAIN_2 = {"seed": 5, "faults": [
    {"kind": "drop_request", "device_id": "2", "round": 1, "op": "train"}]}
SILENT_UNMASK = {"seed": 5, "faults": [
    {"kind": "drop_request", "device_id": "2", "round": 1, "op": "train"},
    {"kind": "drop_request", "round": 1, "op": "unmask", "count": 0}]}


@pytest.fixture
def plan_installer():
    def install(doc, side):
        text = json.dumps(doc)
        if side == "port":
            faults.install(faults.FaultPlan.from_json(text))
        else:
            jax_faults.install(jax_faults.FaultPlan.from_json(text))

    yield install
    faults.uninstall()
    jax_faults.uninstall()


def _faulted_round(doc, side, install, secure=True, n=4):
    """A warm-up round (JAX's workers compile), then round 1 under
    ``doc``: its record, and the params before and after it."""
    cfgs = configs(num_clients=n, secure_agg=secure)
    with Federation(cfgs, n, coord=side, workers=side, want_evaluator=False,
                    worker_kw=PORT_DRAWS if side == "port" else None) as f:
        f.coord.run_round()
        before = params_of(f.coord)
        f.coord.round_timeout = 4.0
        install(doc, side)
        rec = f.coord.run_round()
        faults.uninstall()
        jax_faults.uninstall()
        return rec, before, params_of(f.coord)


def test_reply_dropped_after_the_share_phase_is_recovered(plan_installer):
    """A FaultPlan drops trainer 2's train request after the share phase
    of round 1: the round completes with the 3 others, and the recovered
    aggregate is their plain sum; JAX's records."""
    rec, _, masked = _faulted_round(DROP_TRAIN_2, "port", plan_installer)
    assert rec["completed"] == 3 and rec["dropped"] == ["2"]
    assert rec["unmask_failed"] is False
    plain_rec, _, plain = _faulted_round(DROP_TRAIN_2, "port",
                                         plan_installer, secure=False)
    assert plain_rec["dropped"] == ["2"]
    _assert_cancel(masked, plain)
    jax_rec, _, _ = _faulted_round(DROP_TRAIN_2, "jax", plan_installer)
    assert_records_match([rec], [jax_rec])


def test_round_without_recovery_shares_is_discarded(plan_installer):
    """Every survivor is silent at unmask: the shares cannot be collected,
    the round is a no-op (``unmask_failed``), as in JAX."""
    rec, before, after = _faulted_round(SILENT_UNMASK, "port",
                                        plan_installer)
    assert rec["unmask_failed"] is True and rec["completed"] == 3
    assert all(np.array_equal(after[k], before[k]) for k in before)
    jax_rec, _, _ = _faulted_round(SILENT_UNMASK, "jax", plan_installer)
    assert_records_match([rec], [jax_rec])


def test_coordinator_view_cannot_unmask_dh():
    """Everything the coordinator holds (the experiment seed, every public
    key, one masked update) recovers nothing of worker 0's delta; worker
    1's private key with worker 0's public record recovers it."""
    cfgs = configs(num_clients=2, secure_agg=True)
    params = jax_init(cfgs[0])
    plain = DeviceWorker(configs(num_clients=2)[1], 0, device="cpu").start()
    try:
        cli = TensorClient(plain.host, plain.port)
        _, true_delta = cli.request({"op": "train", "round": 0}, params,
                                    timeout=WAIT)
        cli.close()
    finally:
        plain.stop()
    with Federation(cfgs, 2, want_evaluator=False,
                    worker_kw=PORT_DRAWS) as f:
        w0, w1 = f.workers
        cli = TensorClient(w0.host, w0.port)
        _, masked = cli.request({"op": "train", "round": 0, "cohort": [0, 1]},
                                params, timeout=WAIT)
        cli.close()
        true_f = sa.flat_wire(true_delta, "cpu")
        masked_f = sa.flat_wire(masked, "cpu")
        assert (masked_f - true_f).abs().max() > 0.1
        # The coordinator's attack: the shared seed's pair masks.
        shapes = [np.shape(l) for l in trees.leaves(masked)]
        attack = [torch.zeros(s) for s in shapes]
        draws = programs.Draws(cfgs[1].run.seed)
        sa.mask_update(attack, 0, [0, 1], lambda a, b: draws.pair_mask(
            0, a, b, shapes, "cpu"))
        attacked = masked_f - torch.cat([t.reshape(-1) for t in attack])
        assert (attacked - true_f).abs().max() > 0.1
        # The pair member's view.
        lookup = BrokerClient(f.broker.host, f.broker.port)
        info0 = fetch_device_info(lookup, "0", timeout=WAIT)
        lookup.close()
        secret = keyexchange.shared_secret(
            w1._dh_priv, keyexchange.decode_public(info0.pubkey))
        member = sa.pairwise_mask_with_keys(
            true_f.numel(), [keyexchange.pair_prng_key(secret, 0, 1)], [1.0],
            0, "cpu")
        torch.testing.assert_close(masked_f - member, true_f, rtol=0,
                                   atol=1e-5)


def test_dh_worker_requires_a_broker_as_jax():
    jcfg, tcfg = configs(num_clients=2, secure_agg=True)
    with pytest.raises(ValueError, match="broker"):
        DeviceWorker(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="broker"):
        jax_worker.DeviceWorker(jcfg, 0)
    _, seeded = configs(num_clients=2, secure_agg=True,
                        secure_agg_key_exchange="shared_seed")
    assert not DeviceWorker(seeded, 0, device="cpu")._dh_mode
