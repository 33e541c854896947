"""Device worker: one federated participant as a network service (the
counterpart of the JAX package's ``comm/worker.py``, speaking its wire
protocol, so a port worker serves a JAX coordinator and back).

The worker holds its partition slice, its model and its optimizer on its
device (the card unless the caller passes ``device="cpu"``), runs the
port's local trainer (``fed/setup.py``, the one ``fed/offline.py`` runs),
serves requests over the tensor plane and enrolls on the control plane.
Parameters cross the wire in the flax layout (``convert.py``).

Requests:
  {"op": "train", "round": r[, "cohort"][, "shares_in"]} + params
                                       ->  delta + meta{weight, ...}
  {"op": "share_setup", "round", "cohort"} -> meta{shares, t, b_commit}:
                                           this round's Shamir shares of
                                           the session DH secret and a
                                           fresh self-mask seed, one
                                           ciphertext per recovery-set
                                           peer
  {"op": "eval"}      + global params  ->  meta{eval_loss, eval_acc}
  {"op": "self_eval"} + global params  ->  meta{self_loss, self_acc, ...}
  {"op": "unmask", "round", "dropped", "alive"} -> recovery shares
  {"op": "unmask", "round", "dropped", "cohort"} -> the summed pair masks
                                           shared with the dropped peers
  {"op": "challenge", "nonce", "pub"}  ->  meta{tag}
  {"op": "info"}                       ->  meta{num_examples, ...}

Secure aggregation masks the flat wire tree on the worker's device with
the port's own streams (``privacy/secure_agg.py``), so every party to a
secure round runs on one device type.

With ``fed.lora_rank`` > 0 the broadcast is a ``{"base", "factors"}``
composite (``fed/lora.py``): the worker trains the factors only
(``fed/setup.lora_trainer_for_config``) and ships the factor delta, to
which DP, the uplink codec with its feedback and the masks apply, as in
JAX.

Every request runs under a ``worker.<op>`` span; a train request's
``deserialize_params``, ``local_train``, ``secure_mask`` and
``compress_delta`` spans run inside it.  When the request carries a span
context, the spans finished while handling it go back in the reply
meta's ``trace_spans``, where the coordinator adopts them; the worker's
own tracer records nothing (a long-lived worker must not grow a span
log), as in JAX.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import convert, telemetry
from colearn_federated_learning_tpu_torch.comm import downlink, enrollment
from colearn_federated_learning_tpu_torch.comm import keyexchange, protocol
from colearn_federated_learning_tpu_torch.comm.broker import BrokerClient
from colearn_federated_learning_tpu_torch.comm.transport import TensorServer
from colearn_federated_learning_tpu_torch.data import registry as data_registry
from colearn_federated_learning_tpu_torch.data.sharding import pack_client_shards
from colearn_federated_learning_tpu_torch.fed import compression, evaluation
from colearn_federated_learning_tpu_torch.fed import programs, strategies
from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
from colearn_federated_learning_tpu_torch.fed.engine import partition_for_config
from colearn_federated_learning_tpu_torch.models import registry as model_registry
from colearn_federated_learning_tpu_torch.privacy import dropout
from colearn_federated_learning_tpu_torch.privacy import secure_agg as sa
from colearn_federated_learning_tpu_torch.utils import trees
from colearn_federated_learning_tpu_torch.utils.config import ExperimentConfig
from colearn_federated_learning_tpu_torch.utils.device import resolve_device


def tree_global_norm(tree: Any) -> float:
    """sqrt of the f32 sum of squares, as the JAX package's
    ``pytrees.tree_global_norm``."""
    sq = sum(np.sum(np.square(np.asarray(l, np.float32)), dtype=np.float32)
             for l in trees.leaves(tree))
    return float(np.sqrt(np.float32(sq)))


class DeviceWorker:
    """One device process or thread: local shard, trainer, tensor server.

    ``draws`` supplies the batch indices, DP noise and shared-seed masks
    (:class:`fed.programs.Draws` by default); tests pass the JAX
    package's batch draws."""

    def __init__(
        self,
        config: ExperimentConfig,
        client_id: int,
        broker_host: Optional[str] = None,
        broker_port: Optional[int] = None,
        dataset: Optional[data_registry.Dataset] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        mud_profile: Optional[str] = None,
        device=None,
        draws=None,
    ):
        self.config = config
        self.client_id = int(client_id)
        c = config
        setup_lib.require_stateless_strategy(c, "the socket worker")
        if c.fed.secure_agg and c.fed.secure_agg_neighbors and (
            c.fed.secure_agg_neighbors % 2 or c.fed.secure_agg_neighbors < 2
        ):
            raise ValueError(
                "secure_agg_neighbors must be an even integer >= 2, got "
                f"{c.fed.secure_agg_neighbors}")
        if c.fed.secure_agg and c.fed.compress != "none":
            raise ValueError(
                "secure_agg over the wire cannot compress: masked updates "
                "are dense gaussian-scale payloads, and lossy compression "
                "would break the pairwise mask cancellation")
        if c.fed.secure_agg and c.fed.compress_feedback:
            raise ValueError(
                "secure_agg cannot carry uplink error feedback: masked "
                "updates are dense by construction, so there is no "
                "compression residual to feed back")
        if c.fed.secure_agg_key_exchange not in ("dh", "shared_seed"):
            raise ValueError(
                "secure_agg_key_exchange must be 'dh' or 'shared_seed', "
                f"got {c.fed.secure_agg_key_exchange!r}")
        if c.fed.secure_agg and not 0.0 < c.fed.secure_agg_threshold <= 1.0:
            raise ValueError(
                "secure_agg_threshold must be in (0, 1], got "
                f"{c.fed.secure_agg_threshold}")
        self._dh_mode = (c.fed.secure_agg
                         and c.fed.secure_agg_key_exchange == "dh")
        self._dh_lock = threading.Lock()
        if self._dh_mode:
            if broker_host is None:
                raise ValueError(
                    "secure_agg with key_exchange='dh' needs the broker "
                    "control plane to distribute public keys; pass "
                    "secure_agg_key_exchange='shared_seed' ONLY if you "
                    "trust the coordinator with every pair key")
            self._dh_lookup: Optional[BrokerClient] = None
            self._dh_stopped = False
            self._peer_info_cache: dict = {}   # cleared each round
            # id -> (pubkey text, pair stream seed, raw DH secret bytes)
            self._peer_keys: dict = {}
            self._peer_round: Optional[int] = None
            # Dropout recovery (privacy/dropout.py): per-round self-mask
            # seeds, decrypted incoming shares keyed (round, origin), and
            # the ledger that reveals at most ONE of {self-mask share,
            # session-secret share} per (round, origin).
            self._round_secrets: dict = {}
            self._incoming_shares: dict = {}
            self._revealed: dict = {}
        # The announced pubkey is the device's identity (the session key
        # in dh mode, else one made for identity alone).
        self._id_priv, self._id_pub = keyexchange.generate_keypair()
        if self._dh_mode:
            self._dh_priv, self._dh_pub = self._id_priv, self._id_pub

        self.device = resolve_device(device)
        self._draws = draws if draws is not None else programs.Draws(
            c.run.seed)
        ds = dataset or data_registry.get_dataset(c.data.dataset,
                                                  seed=c.run.seed)
        self._dataset = ds
        labels = np.asarray(ds.y_train)
        parts = partition_for_config(c, labels)
        if not 0 <= self.client_id < len(parts):
            raise ValueError(
                f"client_id {self.client_id} out of range [0, {len(parts)})")
        shard = pack_client_shards(
            np.asarray(ds.x_train), labels, [parts[self.client_id]],
            capacity=c.data.max_examples_per_client)
        self._x_np = shard.x[0]
        self._y_np = shard.y[0]
        self._x = torch.from_numpy(shard.x[0]).to(self.device)
        self._y = torch.from_numpy(shard.y[0].astype(np.int64)).to(self.device)
        self.num_examples = int(shard.counts[0])
        self._model = model_registry.build_model(
            setup_lib.local_model_config(c.model), self.device,
            input_shape=shard.x.shape[2:])
        self._lora = c.fed.lora_rank > 0
        self._wire_template = None      # built on first use
        if self._lora:
            # The factor-only trainer: the base stays frozen and the reply
            # is the factor delta.
            self._update_fn, self._num_steps = (
                setup_lib.lora_trainer_for_config(c, self._model,
                                                  shard.capacity))
        else:
            self._update_fn, self._num_steps = (
                setup_lib.local_trainer_for_config(c, self._model,
                                                   shard.capacity))
        # One request at a time uses the model (a late request abandoned
        # by the coordinator may overlap the next one).
        self._model_lock = threading.Lock()
        self._eval_fn = None
        self._self_eval_fn = None
        # Spans are captured per request and shipped in the reply; the
        # local buffer stays off.
        self.tracer = telemetry.Tracer(process=f"worker-{self.client_id}",
                                       enabled=False)
        self._server = TensorServer(self._handle, host=host, port=port,
                                    ident=str(self.client_id))
        self._broker: Optional[BrokerClient] = None
        self._broker_addr = (broker_host, broker_port)
        self._mud_profile = mud_profile or ""
        self.role: Optional[str] = None
        self._watch_stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        # Last applied global params, engaged by the first broadcast that
        # carries a downlink mode (compress_down).
        self._param_cache: Optional[downlink.WorkerParamCache] = None
        # Uplink error-feedback residual (compress_feedback); reset on a
        # resync, since it belongs to an update the server never folded.
        self._uplink_residual: Optional[Any] = None
        # Adaptive topk density (topk_adaptive), clipped to the band.
        self._topk_fraction = float(c.fed.topk_fraction)
        if c.fed.topk_adaptive:
            self._topk_fraction = min(
                float(c.fed.topk_max_fraction),
                max(float(c.fed.topk_min_fraction), self._topk_fraction))
        self._last_residual_norm: Optional[float] = None

    # ------------------------------------------------------------------
    @property
    def port(self) -> int:
        return self._server.port

    @property
    def host(self) -> str:
        return self._server.host

    def start(self) -> "DeviceWorker":
        """Serve; with a broker address, enroll there and start the
        watchdog that re-enrolls after a broker restart."""
        self._server.start()
        bh, bp = self._broker_addr
        if bh is not None:
            self._broker = BrokerClient(bh, bp,
                                        timeout=protocol.CONNECT_TIMEOUT)
            self._announce(self._broker)
            self._watchdog = threading.Thread(
                target=self._watch_broker,
                name=f"worker-{self.client_id}-watchdog", daemon=True)
            self._watchdog.start()
        return self

    def _announce(self, broker: BrokerClient) -> None:
        """Subscribe to our role topic before announcing (no race)."""
        broker.subscribe(enrollment.ROLE_TOPIC + str(self.client_id))
        enrollment.announce(broker, enrollment.DeviceInfo(
            device_id=str(self.client_id), host=self.host, port=self.port,
            num_examples=self.num_examples, dataset=self.config.data.dataset,
            pubkey=keyexchange.encode_public(self._id_pub),
            mud=self._mud_profile))

    def _watch_broker(self, poll: float = 0.5) -> None:
        """When the broker connection dies, reconnect with backoff and
        re-announce (the retained enrollment died with the old broker);
        each recovery counts in ``comm.reenroll_total``."""
        bh, bp = self._broker_addr
        backoff = poll
        while not self._watch_stop.wait(poll):
            broker = self._broker
            if broker is None or broker.alive():
                backoff = poll
                continue
            try:
                fresh = BrokerClient(bh, bp, timeout=protocol.CONNECT_TIMEOUT)
            except OSError:
                if self._watch_stop.wait(backoff):
                    return
                backoff = min(5.0, backoff * 2.0)
                continue
            broker.close()
            self._broker = fresh
            if self._dh_mode:
                with self._dh_lock:
                    if self._dh_lookup is not None:
                        self._dh_lookup.close()
                        self._dh_lookup = None
            self._announce(fresh)
            telemetry.get_registry().counter("comm.reenroll_total").inc()
            backoff = poll

    def await_role(self, timeout: float = 30.0) -> str:
        if self._broker is None:
            raise RuntimeError("worker was started without a broker")
        self.role = enrollment.await_role(self._broker, str(self.client_id),
                                          timeout=timeout)
        return self.role

    def stop(self) -> None:
        # The watchdog first: our own broker close is no broker death.
        self._watch_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
        self._server.stop()
        if self._broker is not None:
            self._broker.close()
        if self._dh_mode:
            with self._dh_lock:
                self._dh_stopped = True
                if self._dh_lookup is not None:
                    self._dh_lookup.close()
                    self._dh_lookup = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------
    def _handle(self, header: dict, tree: Any) -> tuple[dict, Any]:
        """Dispatch one request under a ``worker.<op>`` span, parented on
        the request's span context; with a context, every span finished
        while handling it goes back in the reply meta."""
        op = header.get("op")
        ctx = protocol.extract_trace(header)
        attrs = {"client_id": self.client_id}
        if "round" in header:
            attrs["round"] = header["round"]
        with self.tracer.capture() as captured:
            with self.tracer.span(f"worker.{op}", parent=ctx, **attrs):
                out_header, out_tree = self._dispatch(op, header, tree)
        if ctx is not None and "meta" in out_header:
            out_header["meta"][protocol.TRACE_SPANS_KEY] = [
                s.to_dict() for s in captured]
        return out_header, out_tree

    def _dispatch(self, op, header: dict, tree: Any) -> tuple[dict, Any]:
        if op == "train":
            return self._train(int(header.get("round", 0)), tree,
                               cohort=header.get("cohort"),
                               meta=header.get("meta"),
                               shares_in=header.get("shares_in"))
        if op == "share_setup":
            return self._share_setup(int(header.get("round", 0)),
                                     header.get("cohort", []))
        if op == "unmask":
            if "alive" in header:
                return self._unmask_shares(int(header.get("round", 0)),
                                           header.get("dropped", []),
                                           header.get("alive", []))
            return self._unmask(int(header.get("round", 0)),
                                header.get("dropped", []),
                                header.get("cohort", []))
        if op == "eval":
            return self._eval(tree)
        if op == "self_eval":
            return self._self_eval(tree)
        if op == "challenge":
            return self._challenge(header)
        if op == "info":
            return ({"meta": {"client_id": self.client_id,
                              "num_examples": self.num_examples,
                              "num_steps": self._num_steps}}, None)
        return ({"status": "error", "error": f"unknown op {op!r}"}, None)

    def _challenge(self, header: dict) -> tuple[dict, Any]:
        """Prove possession of the identity key behind the announced
        pubkey: sha256(DH(id_priv, pub) ‖ nonce)."""
        try:
            secret = keyexchange.shared_secret(
                self._id_priv,
                keyexchange.decode_public(str(header.get("pub", ""))))
            tag = hashlib.sha256(
                secret + bytes.fromhex(str(header.get("nonce", "")))
            ).hexdigest()
        except ValueError as e:
            return ({"status": "error", "error": f"bad challenge: {e}"}, None)
        return ({"meta": {"client_id": self.client_id, "tag": tag}}, None)

    def _partner_row(self, round_idx: int, cohort: list) -> np.ndarray:
        """This client's pairing partners for the round, derived from the
        shared experiment seed as the engine derives them
        (``privacy/secure_agg.partner_table``)."""
        cohort_ids = np.asarray(sorted(int(c) for c in cohort), np.int64)
        neighbors = self.config.fed.secure_agg_neighbors
        ring = (self._draws.ring_order(round_idx, cohort_ids)
                if neighbors else None)
        return np.asarray(sa.partner_table(
            np.asarray([self.client_id]), cohort_ids, neighbors, ring)[0])

    def _dh_pair_keys(self, partner_ids, round_idx: int) -> tuple:
        """(stream seeds, signs) for ``partner_ids``, from DH secrets only
        the pair's members can compute."""
        with self._dh_lock:
            keys, signs = [], []
            for p in np.asarray(partner_ids).tolist():
                p = int(p)
                if p == self.client_id:
                    keys.append(0)                 # self-pair: sign 0
                    signs.append(0.0)
                    continue
                keys.append(self._peer_record(p, round_idx)[1])
                signs.append(1.0 if p > self.client_id else -1.0)
        return keys, signs

    def _peer_record(self, p: int, round_idx: int) -> tuple:  # colearn: holds(_dh_lock)
        """(pubkey text, pair stream seed, raw DH secret) for peer ``p``,
        from its retained enrollment record, refetched once per round (a
        restarted peer re-enrolls with a fresh key).  Caller holds
        ``_dh_lock``, which serialises this dedicated broker connection."""
        if self._dh_stopped:
            raise RuntimeError("worker is stopped")
        if self._dh_lookup is None:
            bh, bp = self._broker_addr
            self._dh_lookup = BrokerClient(  # colearn: noqa(CL019): _dh_lock serializes this dedicated connection by design; ctor bounded by CONNECT_TIMEOUT
                bh, bp, timeout=protocol.CONNECT_TIMEOUT)
        if self._peer_round != round_idx:
            self._peer_info_cache.clear()
            self._peer_round = round_idx
        info = enrollment.fetch_device_info(self._dh_lookup, str(p),
                                            cache=self._peer_info_cache)
        if not info.pubkey:
            raise RuntimeError(
                f"peer {p} enrolled without a DH public key; all cohort "
                "members must run secure_agg_key_exchange='dh'")
        cached = self._peer_keys.get(p)
        if cached is None or cached[0] != info.pubkey:
            secret = keyexchange.shared_secret(
                self._dh_priv, keyexchange.decode_public(info.pubkey))
            cached = (info.pubkey,
                      keyexchange.pair_prng_key(secret, self.client_id, p),
                      secret)
            self._peer_keys[p] = cached
        return cached

    def _recovery_set(self, round_idx: int, cohort: list) -> list:
        """The round's distinct non-self partners: the Shamir
        shareholders."""
        row = self._partner_row(round_idx, cohort).tolist()
        return sorted({int(p) for p in row} - {self.client_id})

    def _share_setup(self, round_idx: int, cohort: list) -> tuple[dict, Any]:
        """Phase 1 of the dropout-tolerant secure round: mint the round's
        self-mask seed and Shamir-share it, with the session DH secret,
        across the recovery set, one ciphertext per shareholder."""
        if not self.config.fed.secure_agg:
            return ({"status": "error",
                     "error": "share_setup requires secure_agg"}, None)
        empty = {"meta": {"client_id": self.client_id, "shares": {}, "t": 0,
                          "b_commit": ""}}
        if not self._dh_mode:
            # shared_seed: the coordinator recovers dropouts locally.
            return (empty, None)
        rs = self._recovery_set(round_idx, cohort)
        if not rs:
            # Solo cohort: no shareholders, so no self-mask either.
            self._store_round_secret(round_idx, None)
            return (empty, None)
        t = dropout.threshold_count(len(rs),
                                    self.config.fed.secure_agg_threshold)
        b = dropout.random_secret()
        xs = [p + 1 for p in rs]
        s_shares = dropout.split_secret(self._dh_priv, xs, t)
        b_shares = dropout.split_secret(b, xs, t)
        shares = {}
        with self._dh_lock:
            for p in rs:
                secret = self._peer_record(p, round_idx)[2]
                shares[str(p)] = dropout.encrypt_share(
                    secret, self.client_id, p, round_idx,
                    s_shares[p + 1], b_shares[p + 1])
        self._store_round_secret(round_idx, b)
        return ({"meta": {"client_id": self.client_id, "shares": shares,
                          "t": t, "b_commit": dropout.commitment(b)}}, None)

    def _store_round_secret(self, round_idx: int, b) -> None:
        """Remember the round's self-mask seed; expire rounds older than
        16."""
        self._round_secrets[round_idx] = b
        cutoff = round_idx - 16
        if any(r < cutoff for r in self._round_secrets):
            self._round_secrets = {r: v for r, v in
                                   self._round_secrets.items() if r >= cutoff}
            self._incoming_shares = {k: v for k, v in
                                     self._incoming_shares.items()
                                     if k[0] >= cutoff}
            self._revealed = {k: v for k, v in self._revealed.items()
                              if k[0] >= cutoff}

    def _stash_shares(self, round_idx: int, shares_in: dict) -> None:
        """Decrypt and keep the round's incoming recovery shares."""
        with self._dh_lock:
            for origin, blob in shares_in.items():
                o = int(origin)
                if o == self.client_id:
                    continue
                secret = self._peer_record(o, round_idx)[2]
                self._incoming_shares[(round_idx, o)] = dropout.decrypt_share(
                    secret, o, self.client_id, round_idx, blob)

    def _unmask_shares(self, round_idx: int, dropped: list,
                       alive: list) -> tuple[dict, Any]:
        """Reveal the self-mask share of origins whose update folded and
        the session-secret share of origins reported dead, never both for
        one (round, origin)."""
        s_out: dict = {}
        b_out: dict = {}
        reply: dict = {"client_id": self.client_id,
                       "s_shares": s_out, "b_shares": b_out}
        for kind, ids, out in (("s", dropped, s_out), ("b", alive, b_out)):
            for o in ids:
                o = int(o)
                if o == self.client_id:
                    # Our session secret is never revealed; our own
                    # self-mask seed may be once our update folded (the
                    # only recovery when every shareholder was pruned).
                    if kind == "b":
                        b = self._round_secrets.get(round_idx)
                        prior = self._revealed.get((round_idx, o))
                        if b is not None and prior in (None, "b"):
                            self._revealed[(round_idx, o)] = "b"
                            reply["b_self"] = format(b, "x")
                    continue
                stash = self._incoming_shares.get((round_idx, o))
                if stash is None:
                    continue
                prior = self._revealed.get((round_idx, o))
                if prior is not None and prior != kind:
                    continue      # exclusivity: refuse the second kind
                self._revealed[(round_idx, o)] = kind
                out[str(o)] = format(stash[0] if kind == "s" else stash[1],
                                     "x")
        return ({"meta": reply}, None)

    def _resolve_params(self, round_idx: int, meta: Optional[dict],
                        tree: Any) -> Any:
        """The round's full global params from a broadcast; ``None`` when a
        compressed broadcast cannot be rebuilt (resync)."""
        mode = meta.get(downlink.DOWN_KEY) if meta else None
        if mode is None and self._param_cache is None:
            return tree
        if self._param_cache is None:
            self._param_cache = downlink.WorkerParamCache()
        return self._param_cache.resolve(round_idx, meta or {}, tree)

    def _settle(self) -> None:
        """Wait for the card's queued work, so the span around it covers
        the work and not only its queueing."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train(self, round_idx: int, global_params: Any, cohort=None,
               meta=None, shares_in=None) -> tuple[dict, Any]:
        c = self.config
        tracer = self.tracer
        with self._model_lock:
            with tracer.span("deserialize_params"):
                full = self._resolve_params(round_idx, meta, global_params)
                if full is None:
                    # The residual belongs to an update that never made it
                    # into the fold: it goes with the stale base.
                    self._uplink_residual = None
                    self._last_residual_norm = None
                    return ({"status": "resync",
                             "error": f"client {self.client_id} has no "
                                      f"cached base for round {round_idx} "
                                      "delta"}, None)
                if self._lora:
                    # Composite broadcast: the frozen base and this
                    # cycle's factors (compress_down is refused under
                    # LoRA, so this is the plain decoded frame).
                    args = (setup_lib.flax_to_params(
                        self._model, full["base"], self.device),
                        trees.map_leaves(
                            lambda l: torch.from_numpy(
                                np.array(l, np.float32)).to(self.device),
                            full["factors"]))
                else:
                    args = (setup_lib.flax_to_params(self._model, full,
                                                     self.device),)
            with tracer.span("local_train", steps=self._num_steps):
                idx = self._draws.batch_indices(round_idx, self.client_id,
                                                self.num_examples,
                                                self._num_steps,
                                                c.fed.batch_size)
                result = self._update_fn(
                    *args, self._x, self._y, self.num_examples,
                    torch.as_tensor(np.asarray(idx), dtype=torch.long).to(
                        self.device),
                    self._num_steps,
                    strategies.lr_scale_for_round(c.fed, round_idx))
                self._settle()
            delta, weight = setup_lib.finalize_client_delta(
                c, result, self.client_id, round_idx, self._draws)
            mean_loss = float(result.mean_loss)
        fed = c.fed
        delta_np = None
        if fed.secure_agg:
            if not cohort:
                return ({"status": "error",
                         "error": "secure_agg train request lacks the "
                                  "round cohort"}, None)
            if self._dh_mode and shares_in:
                self._stash_shares(round_idx, shares_in)
            with tracer.span("secure_mask", dh=self._dh_mode):
                # The masks run on the flax-layout wire tree.
                delta_np = self._mask(round_idx, cohort,
                                      self._wire_tree(delta))
            weight = 1.0      # masked aggregation is a plain sum
        out_meta = {"round": round_idx, "weight": weight,
                    "client_id": self.client_id,
                    "num_examples": int(result.num_examples)}
        if not fed.secure_agg:
            # The per-client loss is what the masks hide.
            out_meta["mean_loss"] = mean_loss
        with tracer.span("compress_delta", codec=fed.compress):
            if delta_np is None:
                delta_np = self._wire_tree(delta)
            if fed.compress_feedback and not fed.secure_agg \
                    and fed.compress != "none":
                wire, cmeta, self._uplink_residual = \
                    compression.feedback_compress(
                        delta_np, self._uplink_residual, fed.compress,
                        topk_fraction=self._topk_fraction)
                norm = tree_global_norm(self._uplink_residual)
                telemetry.get_registry().gauge(
                    "fed.uplink_residual_norm").set(norm)
                self._adapt_topk(norm)
            else:
                wire, cmeta = compression.compress_delta(
                    delta_np, fed.compress, topk_fraction=fed.topk_fraction)
        out_meta.update(cmeta)
        return ({"meta": out_meta}, wire)

    def _mask(self, round_idx: int, cohort: list, delta_np: Any) -> Any:
        """The masked wire update: pair masks (DH or shared seed) and, after
        a share phase, the self-mask, drawn on the worker's device."""
        partners = self._partner_row(round_idx, cohort)
        if self._dh_mode:
            keys, signs = self._dh_pair_keys(partners, round_idx)
            flat = sa.mask_update_with_keys(
                sa.flat_wire(delta_np, self.device), keys, signs, round_idx)
            b = self._round_secrets.get(round_idx)
            if b is not None:
                # The self-mask rides only when this round's share phase
                # distributed its removal shares.
                flat = sa.mask_update_with_keys(
                    flat, [dropout.self_mask_key(b)], [1.0], round_idx)
            return sa.unflat_wire(delta_np, flat)
        leaves = [torch.from_numpy(np.asarray(l, np.float32)).to(self.device)
                  for l in trees.leaves(delta_np)]
        shapes = [t.shape for t in leaves]
        sa.mask_update(leaves, self.client_id, partners,
                       lambda a, b: self._draws.pair_mask(
                           round_idx, a, b, shapes, self.device))
        return trees.unflatten(delta_np, [t.cpu().numpy() for t in leaves])

    def _adapt_topk(self, norm: float) -> None:
        """Adaptive topk density: widen the frame (x1.25) when the
        feedback residual's norm grows, tighten it (x0.9) when it shrinks,
        within [topk_min_fraction, topk_max_fraction]."""
        fed = self.config.fed
        if not fed.topk_adaptive:
            return
        prev, self._last_residual_norm = self._last_residual_norm, norm
        if prev is not None:
            if norm > prev:
                self._topk_fraction *= 1.25
            elif norm < prev:
                self._topk_fraction *= 0.9
        self._topk_fraction = min(
            float(fed.topk_max_fraction),
            max(float(fed.topk_min_fraction), self._topk_fraction))
        telemetry.get_registry().gauge(
            "fed.topk_fraction_effective").set(self._topk_fraction)

    def _wire_tree(self, delta: list) -> Any:
        """A delta (tensors in the trainer's order) as the flax-layout
        tree of f32 numpy arrays that goes on the wire: the model's tree,
        or the factor tree under LoRA."""
        if self._lora:
            return trees.unflatten(self._wire_shapes(), [
                d.detach().float().cpu().numpy() for d in delta])
        return setup_lib.params_to_flax(self._model, delta, self.config)

    def _wire_shapes(self) -> Any:
        """The flax-layout tree of this worker's wire payload, as
        zero-stride f32 views (shape only): the model's tree, or under
        LoRA its factor tree (the template of masks and recovery)."""
        if self._wire_template is not None:
            return self._wire_template
        shapes = {}
        for name, p in self._model.named_parameters():
            path, fshape, _ = convert.flax_layout(
                name, tuple(p.shape), self.config.model.num_heads)
            node = shapes
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = np.broadcast_to(np.float32(0), fshape)
        if self._lora:
            from colearn_federated_learning_tpu_torch.fed import lora

            shapes = trees.map_leaves(
                lambda t: np.broadcast_to(np.float32(0), tuple(t.shape)),
                lora.init_factors(shapes, self.config.fed.lora_rank,
                                  model_name=self.config.model.name))
        self._wire_template = shapes
        return shapes

    def _unmask(self, round_idx: int, dropped: list,
                cohort: list) -> tuple[dict, Any]:
        """The direct recovery form: the sum of this client's pair masks
        shared with the dropped peers it paired with, as it added them."""
        partners = self._partner_row(round_idx, cohort)
        mine = [int(d) for d in dropped if int(d) in set(partners.tolist())]
        if not mine:
            return ({"meta": {"client_id": self.client_id,
                              "n_dropped_pairs": 0}}, None)
        template = self._wire_shapes()
        if self._dh_mode:
            keys, signs = self._dh_pair_keys(mine, round_idx)
            n = sum(int(np.prod(np.shape(l))) for l in trees.leaves(template))
            mask = sa.unflat_wire(template, sa.pairwise_mask_with_keys(
                n, keys, signs, round_idx, self.device))
        else:
            leaves = [torch.zeros(np.shape(l), device=self.device)
                      for l in trees.leaves(template)]
            shapes = [t.shape for t in leaves]
            sa.mask_update(leaves, self.client_id, mine,
                           lambda a, b: self._draws.pair_mask(
                               round_idx, a, b, shapes, self.device))
            mask = trees.unflatten(template, [t.cpu().numpy() for t in leaves])
        return ({"meta": {"client_id": self.client_id,
                          "n_dropped_pairs": len(mine)}}, mask)

    def _self_eval(self, global_params: Any) -> tuple[dict, Any]:
        """The global model on this device's own shard."""
        if self.config.fed.secure_agg:
            return ({"status": "error",
                     "error": "self_eval is disabled under secure_agg"}, None)
        with self._model_lock:
            if self._self_eval_fn is None:
                n = self.num_examples
                self._self_eval_fn = evaluation.make_eval_fn(
                    self._model, self._x_np[:n], self._y_np[:n],
                    batch=max(self.config.fed.batch_size, 64),
                    device=self.device)
            loss, acc = self._self_eval_fn(setup_lib.flax_to_params(
                self._model, global_params, self.device))
        return ({"meta": {"client_id": self.client_id,
                          "num_examples": self.num_examples,
                          "self_loss": float(loss),
                          "self_acc": float(acc)}}, None)

    def _eval(self, global_params: Any) -> tuple[dict, Any]:
        with self._model_lock:
            if self._eval_fn is None:
                self._eval_fn = evaluation.make_eval_fn(
                    self._model, self._dataset.x_test, self._dataset.y_test,
                    batch=max(self.config.fed.batch_size, 64),
                    device=self.device)
            loss, acc = self._eval_fn(setup_lib.flax_to_params(
                self._model, global_params, self.device))
        return ({"meta": {"eval_loss": float(loss),
                          "eval_acc": float(acc)}}, None)


def run_worker_forever(config: ExperimentConfig, client_id: int,
                       broker_host: str, broker_port: int,
                       mud_profile: Optional[str] = None, device=None,
                       stop: Optional[threading.Event] = None) -> None:
    """Serve until ``stop`` is set (never, without one).  The enrollment
    window is ``config.run.worker_enroll_timeout``; when it passes without
    a role, :class:`enrollment.EnrollmentTimeout` is raised."""
    worker = DeviceWorker(config, client_id, broker_host, broker_port,
                          mud_profile=mud_profile, device=device).start()
    try:
        worker.await_role(timeout=config.run.worker_enroll_timeout)
        (stop or threading.Event()).wait()
    finally:
        worker.stop()
