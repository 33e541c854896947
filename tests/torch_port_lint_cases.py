"""The source snippets of ``tests/test_lint.py`` and
``tests/test_lint_concurrency.py``, copied for the port's lint-parity test
(``tests/test_torch_port_lint.py``): each case is ``(id, relpath, rules,
source)``, the file's path under a scratch root (its directories scope
the rules), the rule ids the case runs (``None``: every rule the port
keeps) and the dedented source.  The cases that run only CL001 are left
out, since the port has no CL001; identical cases appear once."""

CASES = [
    ('cl001_flags_time_call_in_jit_call_site_target', 'pkg/fed/mod.py', None,
     """
import time
from jax import jit

def train(x):
    t0 = time.perf_counter()
    return x + t0

train_fast = jit(train)
"""),
    ('cl002_flags_untimed_client_and_recv_in_comm', 'pkg/comm/mod.py', None,
     """
from pkg.broker import BrokerClient

def attach(host, port):
    return BrokerClient(host, port)

def drain(sock):
    return sock.recv(4)
"""),
    ('cl002_passes_timeout_kwarg_and_timeout_bearing_function', 'pkg/comm/mod.py', None,
     """
from pkg.broker import BrokerClient

def attach(host, port):
    return BrokerClient(host, port, timeout=5.0)

def drain(sock, timeout):
    sock.settimeout(timeout)
    return sock.recv(4)
"""),
    ('cl002_only_applies_under_comm', 'pkg/fed/mod.py', None,
     """
def drain(sock):
    return sock.recv(4)
"""),
    ('cl002_suppression', 'pkg/comm/mod.py', None,
     """
def accept_forever(srv):
    return srv.accept()  # colearn: noqa(CL002): test fixture
"""),
    ('cl003_flags_bare_except_and_swallowed_handler', 'pkg/comm/mod.py', None,
     """
def teardown(sock):
    try:
        sock.close()
    except OSError:
        pass
    try:
        sock.detach()
    except:
        return None
"""),
    ('cl003_allows_handlers_with_real_bodies', 'pkg/comm/mod.py', None,
     """
def teardown(sock, counter):
    try:
        sock.close()
    except OSError:
        counter.inc()
"""),
    ('cl003_suppression', 'pkg/comm/mod.py', None,
     """
def teardown(sock):
    try:
        sock.close()
    except OSError:  # colearn: noqa(CL003): test fixture
        pass
"""),
    ('cl004_flags_wall_clock_and_unseeded_rng_in_faults', 'pkg/faults/mod.py', None,
     """
import random
import time

def jitter():
    return random.random() + time.time()
"""),
    ('cl004_allows_seeded_rng_and_monotonic', 'pkg/faults/mod.py', None,
     """
import random
import time

def jitter(seed):
    rng = random.Random(seed)
    return rng.uniform(0, 1), time.monotonic()
"""),
    ('cl004_suppression', 'pkg/faults/mod.py', None,
     """
import time

def stamp():
    return time.time()  # colearn: noqa(CL004): test fixture
"""),
    ('cl005_flags_typoed_counter_name', 'pkg/fed/mod.py', None,
     """
def bump(registry):
    registry.counter("comm.retry_totl").inc()
"""),
    ('cl005_passes_catalog_names_and_wildcard_fstrings', 'pkg/fed/mod.py', None,
     """
def bump(registry, kind):
    registry.counter("comm.retry_total").inc()
    registry.counter(f"fault.injected.{kind}").inc()
    registry.histogram("fed.round_time_s").observe(1.0)
"""),
    ('cl005_flags_fstring_with_unknown_prefix', 'pkg/fed/mod.py', None,
     """
def bump(registry, kind):
    registry.counter(f"surprise.{kind}").inc()
"""),
    ('cl005_suppression', 'pkg/fed/mod.py', None,
     """
def bump(registry):
    registry.counter("scratch.local_only").inc()  # colearn: noqa(CL005): test fixture
"""),
    ('cl005_flags_non_literal_metric_name', 'pkg/fed/mod.py', None,
     """
def bump(registry, name):
    registry.counter(name).inc()
"""),
    ('cl005_non_literal_suppression', 'pkg/fed/mod.py', None,
     """
def snapshot(registry, names):
    return {n: registry.counter(n).value  # colearn: noqa(CL005): test fixture
            for n in names}
"""),
    ('cl006_flags_host_sync_in_traced_function', 'pkg/fed/mod.py', None,
     """
import jax

@jax.jit
def step(x):
    return float(x)
"""),
    ('cl006_flags_block_until_ready_in_hot_loop', 'pkg/fed/mod.py', None,
     """
def fit(batches):
    for b in batches:  # colearn: hot
        b.result.block_until_ready()
"""),
    ('cl006_suppression', 'pkg/fed/mod.py', None,
     """
import jax

@jax.jit
def step(x):
    return float(x)  # colearn: noqa(CL006): test fixture
"""),
    ('cl006_allows_host_sync_outside_hot_paths', 'pkg/fed/mod.py', None,
     """
def summarize(x):
    return float(x)
"""),
    ('cl007_flags_per_request_encode_in_hot_fanout_loop', 'pkg/comm/mod.py', None,
     """
from pkg.utils.serialization import pytree_to_bytes

def broadcast(devs, params):
    for d in devs:  # colearn: hot
        d.send(pytree_to_bytes(params))
"""),
    ('cl007_allows_encode_hoisted_before_the_loop', 'pkg/comm/mod.py', None,
     """
from pkg.utils.serialization import pytree_to_bytes

def broadcast(devs, params):
    body = pytree_to_bytes(params)
    for d in devs:  # colearn: hot
        d.send(body)
"""),
    ('cl007_ignores_loops_not_marked_hot', 'pkg/comm/mod.py', None,
     """
from pkg.utils.serialization import pytree_to_bytes

def snapshot_all(trees):
    for t in trees:
        yield pytree_to_bytes(t)
"""),
    ('cl007_suppression', 'pkg/comm/mod.py', None,
     """
from pkg.utils.serialization import save_pytree_npz

def dump(devs, params):
    for d in devs:  # colearn: hot
        save_pytree_npz(d.path, params)  # colearn: noqa(CL007): test fixture
"""),
    ('cl008_flags_in_place_exchange_writes_in_fed', 'pkg/fed/exchange.py', None,
     '\nimport numpy as np\nfrom pkg.utils.serialization import save_pytree_npz\n\ndef publish(path, tree):\n    save_pytree_npz(path, tree)\n\ndef manifest(path, names):\n    with open(path, "w") as f:\n        f.write("\\n".join(names))\n\ndef raw(path, arrs):\n    np.savez(path, **arrs)\n'),
    ('cl008_allows_temp_plus_replace_in_same_function', 'pkg/fed/exchange.py', None,
     """
import os
from pkg.utils.serialization import save_pytree_npz

def publish(path, tree):
    tmp = path + ".tmp"
    save_pytree_npz(tmp, tree)
    os.replace(tmp, path)
"""),
    ('cl008_ignores_writes_outside_fed', 'pkg/telemetry/dump.py', None,
     """
def snapshot(path, blob):
    with open(path, "wb") as f:
        f.write(blob)
"""),
    ('cl008_ignores_reads_and_appends', 'pkg/fed/offline.py', None,
     """
def load(path):
    with open(path, "rb") as f:
        return f.read()

def journal(path, line):
    with open(path, "a") as f:
        f.write(line)
"""),
    ('cl008_suppression', 'pkg/fed/exchange.py', None,
     """
def scratch(path, blob):
    with open(path, "wb") as f:  # colearn: noqa(CL008): test fixture
        f.write(blob)
"""),
    ('cl009_flags_per_device_loop_in_hot_path', 'pkg/fleetsim/mod.py', None,
     """
def run_round(cohort_ids, train_one):
    out = []
    for device_id in cohort_ids:  # colearn: hot
        out.append(train_one(device_id))
    return out
"""),
    ('cl009_flags_local_update_call_per_iteration', 'pkg/fleetsim/sim.py', None,
     """
def run_round(chunks, local_update, params):
    acc = None
    for chunk in chunks:  # colearn: hot
        acc = local_update(params, chunk)
    return acc
"""),
    ('cl009_allows_chunk_loop', 'pkg/fleetsim/sim.py', None,
     """
def run_round(n, chunk, chunk_fn, fold, acc):
    for lo in range(0, n, chunk):  # colearn: hot
        acc = fold(acc, chunk_fn(lo))
    return acc
"""),
    ('cl009_ignores_unmarked_and_non_fleetsim_loops', 'pkg/fleetsim/population.py', None,
     """
def setup(device_ids, probe):
    for device_id in device_ids:
        probe(device_id)

"""),
    ('cl009_ignores_unmarked_and_non_fleetsim_loops-1', 'pkg/comm/mod.py', None,
     """def elsewhere(client_ids, send):
            for client_id in client_ids:  # colearn: hot
                send(client_id)
"""),
    ('cl009_suppression', 'pkg/fleetsim/mod.py', None,
     """
def debug_round(cohort_ids, train_one):
    for device_id in cohort_ids:  # colearn: hot  # colearn: noqa(CL009): test fixture
        train_one(device_id)
"""),
    ('cl010_flags_print_to_stdout_in_library_code', 'pkg/comm/mod.py', None,
     """
def announce(port):
    print({"port": port})
"""),
    ('cl010_flags_explicit_sys_stdout', 'pkg/fed/mod.py', None,
     """
import sys

def announce(port):
    print(port, file=sys.stdout)
"""),
    ('cl010_allows_stderr_and_file_objects', 'pkg/comm/mod.py', None,
     """
import sys

def announce(port, log):
    print(port, file=sys.stderr)
    print(port, file=log)
"""),
    ('cl010_exempts_cli_scripts_and_main_guards', 'pkg/cli.py', None,
     """
def report(x):
    print(x)
"""),
    ('cl010_exempts_cli_scripts_and_main_guards-1', 'pkg/bench.py', None,
     """
def report(x):
    print(x)
"""),
    ('cl010_exempts_cli_scripts_and_main_guards-2', 'pkg/scripts/tool.py', None,
     """
def report(x):
    print(x)
"""),
    ('cl010_exempts_cli_scripts_and_main_guards-3', 'pkg/native/build.py', None,
     """
def build():
    return "x"

if __name__ == "__main__":
    print(build())
"""),
    ('cl010_suppression', 'pkg/fed/mod.py', None,
     """
def report(x):
    print(x)  # colearn: noqa(CL010): test fixture
"""),
    ('cl011_flags_expander_call_per_pair', 'pkg/privacy/mod.py', None,
     """
from pkg.privacy.secure_agg import pairwise_mask

def mask_all(update, key, me, partners, rnd):
    for p in partners:  # colearn: hot
        update = update + pairwise_mask(update, key, me, p, rnd)
    return update
"""),
    ('cl011_flags_per_pair_head_in_comm', 'pkg/comm/mod.py', None,
     """
def fold_masks(pair_rows, expand, acc):
    for pair in pair_rows:  # colearn: hot
        acc = acc + expand(pair)
    return acc
"""),
    ('cl011_allows_key_derivation_loop', 'pkg/comm/worker.py', None,
     """
from pkg.comm.keyexchange import pair_prng_key, shared_secret
from pkg.privacy.secure_agg import mask_update_with_keys

def mask(update, priv, me, peers, pubs, signs, rnd):
    keys = []
    for p in peers:  # colearn: hot
        keys.append(pair_prng_key(shared_secret(priv, pubs[p]),
                                  me, p))
    return mask_update_with_keys(update, keys, signs, rnd)
"""),
    ('cl011_ignores_unmarked_and_out_of_scope_loops', 'pkg/privacy/mod.py', None,
     """
from pkg.privacy.secure_agg import pairwise_mask

def cold(update, key, me, partners, rnd):
    for p in partners:
        update = update + pairwise_mask(update, key, me, p, rnd)
    return update
"""),
    ('cl011_ignores_unmarked_and_out_of_scope_loops-1', 'pkg/fleetsim/mod.py', None,
     """
def sweep(pair_counts, probe):
    for pairs in pair_counts:  # colearn: hot
        probe(pairs)
"""),
    ('cl011_suppression', 'pkg/privacy/mod.py', None,
     """
from pkg.privacy.secure_agg import mask_scalar

def debug_mask(xs, key, me, partners, rnd):
    for p in partners:  # colearn: hot  # colearn: noqa(CL011): test fixture
        xs = mask_scalar(xs, key, me, p, rnd)
    return xs
"""),
    ('cl012_flags_device_get_in_hot_wire_path', 'pkg/comm/downlink.py', None,
     """
import jax

def encode_round(rnd, params, codec):
    with codec.span("serialize"):  # colearn: hot
        host = jax.device_get(params)
    return codec.pack(rnd, host)
"""),
    ('cl012_flags_tree_map_asarray_gather', 'pkg/comm/coordinator.py', None,
     """
import jax
import numpy as np

def serialize(params, wire):  # colearn: hot
    host = jax.tree.map(np.asarray, params)
    return wire.pack(host)
"""),
    ('cl012_allows_per_shard_reads_and_cold_paths', 'pkg/comm/downlink.py', ['CL012'],
     """
import numpy as np

def host_read(a):
    out = np.empty(a.shape, a.dtype)
    for sh in a.addressable_shards:  # colearn: hot
        out[sh.index] = np.asarray(sh.data)
    return out
"""),
    ('cl012_allows_per_shard_reads_and_cold_paths-1', 'pkg/comm/coordinator.py', None,
     """
import jax

def evaluate(params, batch):
    return score(jax.device_get(params), batch)
"""),
    ('cl012_allows_per_shard_reads_and_cold_paths-2', 'pkg/ckpt/mod.py', None,
     """
import jax

def snapshot(params):  # colearn: hot
    return jax.device_get(params)
"""),
    ('cl012_suppression', 'pkg/comm/aggregation.py', None,
     """
import jax
import numpy as np

def stage(delta, w):  # colearn: hot
    host = jax.tree.map(np.asarray, delta)  # colearn: noqa(CL012): test fixture
    return scale(host, w)
"""),
    ('cl012_device_fold_region_stays_gather_free', 'pkg/comm/aggregation.py', ['CL012'],
     """
import jax
import numpy as np

def _fold_block_device(self, ids):  # colearn: hot
    leaves, treedef = jax.tree.flatten(self.acc)
    owned = [np.asarray(leaf) * self.w for leaf in leaves]
    return jax.tree.unflatten(treedef, owned)
"""),
    ('cl012_device_fold_region_stays_gather_free-1', 'pkg/comm/aggregation.py', ['CL012'],
     """
import jax
import numpy as np

def _fold_block_device(self, ids):  # colearn: hot
    host = jax.tree.map(np.asarray, self.acc)
    return self.kernel.fold(host)
"""),
    ('cl013_flags_decompress_in_hot_aggregation_path', 'pkg/comm/aggregation.py', ['CL013'],
     """
from pkg.fed import compression

def add(self, meta, delta):  # colearn: hot
    dense = compression.decompress_delta(delta, meta,
                                         shapes=self.shapes)
    return self.stage(dense)
"""),
    ('cl013_flags_full_shape_alloc_in_hot_loop', 'pkg/comm/aggregation.py', ['CL013'],
     """
import numpy as np

def fold(folder, updates):
    for meta, idx, vals in updates:  # colearn: hot
        buf = np.zeros(folder.model_shape, np.float32)
        buf.reshape(-1)[idx] = vals
        folder.accumulate(buf)
"""),
    ('cl013_allows_cold_paths_and_other_dirs', 'pkg/comm/aggregation.py', ['CL013'],
     """
import numpy as np

def finalize(self, staged):
    acc = np.zeros(self.model_shape, np.float32)
    for idx, vals in staged:
        acc.reshape(-1)[idx] += vals
    return acc
"""),
    ('cl013_allows_cold_paths_and_other_dirs-1', 'pkg/fleetsim/mod.py', ['CL013'],
     """
import numpy as np

def estimate(shape):  # colearn: hot
    return np.zeros(shape, np.float32)
"""),
    ('cl013_suppression', 'pkg/comm/aggregation.py', ['CL013'],
     """
from pkg.fed import compression

def add(self, meta, delta):  # colearn: hot
    dense = compression.decompress_delta(  # colearn: noqa(CL013): test fixture
        delta, meta, shapes=self.shapes)
    return self.stage(dense)
"""),
    ('cl014_flags_raw_clock_delta_in_hot_wire_path', 'pkg/comm/coordinator.py', ['CL014'],
     """
import time

def collect(self, devs):  # colearn: hot
    t0 = time.perf_counter()
    out = [self.ask(d) for d in devs]
    dt = time.perf_counter() - t0
    print("collected in", dt)
    return out
"""),
    ('cl014_allows_attributed_deltas_and_deadline_math', 'pkg/comm/aggregation.py', ['CL014'],
     """
import time

def add(self, meta, delta):  # colearn: hot
    t0 = time.perf_counter()
    self.stage(meta, delta)
    self.fold_s += time.perf_counter() - t0
"""),
    ('cl014_allows_attributed_deltas_and_deadline_math-1', 'pkg/comm/aggregator.py', ['CL014'],
     """
import time

def fold(self, reg, parts):  # colearn: hot
    t0 = time.monotonic()
    for p in parts:
        self.merge(p)
    reg.histogram("fed.phase_time_s").observe(
        time.monotonic() - t0)
"""),
    ('cl014_allows_attributed_deltas_and_deadline_math-2', 'pkg/comm/transport.py', ['CL014'],
     """
import time

def wait(self, fut, deadline):  # colearn: hot
    return fut.result(timeout=deadline - time.monotonic())
"""),
    ('cl014_allows_attributed_deltas_and_deadline_math-3', 'pkg/comm/coordinator.py', ['CL014'],
     """
import time

def profile(self, devs):
    t0 = time.time()
    self.ping(devs)
    return time.time() - t0
"""),
    ('cl014_allows_attributed_deltas_and_deadline_math-4', 'pkg/fed/mod.py', ['CL014'],
     """
import time

def step(batch):  # colearn: hot
    t0 = time.perf_counter()
    run(batch)
    return time.perf_counter() - t0
"""),
    ('cl014_suppression', 'pkg/comm/worker.py', ['CL014'],
     """
import time

def drain(self, q):  # colearn: hot
    t0 = time.monotonic()
    q.drain()
    lag = time.monotonic() - t0  # colearn: noqa(CL014): test fixture
    return lag
"""),
    ('cl015_flags_bare_sleep_in_retry_loop', 'pkg/comm/transport.py', ['CL015'],
     """
import time

def request(self, header, retry):
    for attempt in range(retry.max_retries):
        try:
            return self.ask(header)
        except OSError:
            time.sleep(retry.delay(attempt))
"""),
    ('cl015_allows_event_wait_and_one_shot_sleep', 'pkg/comm/worker.py', ['CL015'],
     """
def pump(self):
    while not self._stop.is_set():
        if not self.dispatch():
            self._stop.wait(0.2)
"""),
    ('cl015_allows_event_wait_and_one_shot_sleep-1', 'pkg/comm/broker.py', ['CL015'],
     """
import time

def start(self):
    self.spawn()
    time.sleep(0.1)
"""),
    ('cl015_allows_event_wait_and_one_shot_sleep-2', 'pkg/faults/watch.py', ['CL015'],
     """
import time

def poll(path):
    while not path.exists():
        time.sleep(0.5)
"""),
    ('cl015_suppression', 'pkg/comm/transport.py', ['CL015'],
     """
import time

def settle(self):
    for _ in range(3):
        time.sleep(0.01)  # colearn: noqa(CL015): test fixture
"""),
    ('cl016_flags_uncataloged_record_key', 'pkg/comm/coordinator.py', ['CL016'],
     """
def _round(self, r):
    rec = {"round": r, "completed": 3}
    rec["train_los"] = 1.0
    return rec
"""),
    ('cl016_flags_typo_in_dict_literal_and_update', 'pkg/fleetsim/sim.py', ['CL016'],
     """
def _round(self, r):
    rec = {"round": r, "cohrt": 4}
    rec.update(train_loss=0.5, stalenes_mean=1.0)
    return rec
"""),
    ('cl016_allows_cataloged_keys_and_dynamic_updates', 'pkg/comm/async_coordinator.py', ['CL016'],
     """
def _round(self, r, extras):
    rec = {"round": r, "completed": 3, "train_loss": 0.1}
    rec["conv_update_norm"] = 0.5
    rec.update(**extras)
    rec.update({"staleness_mean": 1.0})
    return rec
"""),
    ('cl016_allows_cataloged_keys_and_dynamic_updates-1', 'pkg/comm/broker.py', ['CL016'],
     """
def reply(self):
    out = {"op": "subscribe_ack", "status": "ok"}
    return out
"""),
    ('cl016_suppression', 'pkg/comm/coordinator.py', ['CL016'],
     """
def _round(self, r):
    rec = {"round": r}
    rec["experimental_key"] = 1  # colearn: noqa(CL016): test fixture
    return rec
"""),
    ('cl023_flags_replace_without_fsync_in_ckpt', 'pkg/ckpt/gen.py', ['CL023'],
     """
import os

def commit(path, body):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, path)
"""),
    ('cl023_flags_in_place_npz_in_offline', 'pkg/fed/offline.py', ['CL023'],
     """
import numpy as np

def export(path, arrays):
    np.savez(path, **arrays)
"""),
    ('cl023_passes_fsync_before_replace_and_atomic_helper', 'pkg/ckpt/streaming.py', ['CL023'],
     """
import os
import numpy as np
from pkg.utils.serialization import atomic_save_pytree_npz

def commit(path, body):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)

def shard_write(path, buffers):
    _atomic_write(path, lambda f: np.savez(f, **buffers))

def export(path, tree):
    atomic_save_pytree_npz(path, tree)
"""),
    ('cl023_only_applies_to_durable_paths', 'pkg/comm/mod.py', ['CL023'],
     """
def scratch(path, body):
    with open(path, "w") as f:
        f.write(body)
"""),
    ('cl023_suppression', 'pkg/ckpt/tmp.py', ['CL023'],
     """
def scratch(path, body):
    with open(path, "w") as f:  # colearn: noqa(CL023): test fixture
        f.write(body)
"""),
    ('cl000_dead_suppression_is_reported', 'pkg/comm/mod.py', None,
     """
X = 1  # colearn: noqa(CL002)
"""),
    ('blanket_noqa_suppresses_every_rule_on_the_line', 'pkg/faults/mod.py', None,
     """
import time

def jitter():
    return time.time()  # colearn: noqa
"""),
    ('syntax_error_becomes_cl999_finding', 'pkg/comm/mod.py', None,
     """def broken(:
"""),
    ('docstring_mentioning_noqa_does_not_suppress', 'pkg/comm/mod.py', None,
     '\ndef teardown(sock):\n    """Mentions # colearn: noqa(CL003) in prose only."""\n    try:\n        sock.close()\n    except OSError:\n        pass\n'),
    ('baseline_absorbs_findings_and_survives_line_shifts', 'pkg/comm/mod.py', None,
     """
def teardown(sock):
    try:
        sock.close()
    except OSError:
        pass
"""),
    ('baseline_absorbs_findings_and_survives_line_shifts-1', 'pkg/comm/mod.py', None,
     """
# shifted
# shifted

def teardown(sock):
    try:
        sock.close()
    except OSError:
        pass
"""),
    ('config_disable_skips_rule', 'pkg/comm/mod.py', None,
     """
def drain(sock):
    return sock.recv(4)
"""),
    ('cl017_flags_bare_access_on_thread_reachable_path', 'pkg/comm/mod.py', ['CL017'],
     """
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def start(self):
        threading.Thread(target=self._loop).start()

    def put(self, k, v):
        with self._lock:
            self._state[k] = v

    def size(self):
        with self._lock:
            return len(self._state)

    def _loop(self):
        return self._state.get("x")
"""),
    ('cl017_suppression', 'pkg/comm/mod.py', ['CL017'],
     """
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def start(self):
        threading.Thread(target=self._loop).start()

    def put(self, k, v):
        with self._lock:
            self._state[k] = v

    def size(self):
        with self._lock:
            return len(self._state)

    def _loop(self):
        return self._state.get("x")  # colearn: noqa(CL017): test fixture
"""),
    ('cl017_quiet_when_access_is_locked', 'pkg/comm/mod.py', ['CL017'],
     """
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def start(self):
        threading.Thread(target=self._loop).start()

    def put(self, k, v):
        with self._lock:
            self._state[k] = v

    def size(self):
        with self._lock:
            return len(self._state)

    def _loop(self):
        with self._lock:
            return self._state.get("x")
"""),
    ('cl017_quiet_off_thread', 'pkg/comm/mod.py', ['CL017'],
     """
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def put(self, k, v):
        with self._lock:
            self._state[k] = v

    def size(self):
        with self._lock:
            return len(self._state)

    def peek(self):
        return self._state.get("x")
"""),
    ('cl017_guarded_by_annotation_overrides_counting', 'pkg/comm/mod.py', ['CL017'],
     """
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}  # colearn: guarded-by(_lock)

    def start(self):
        threading.Thread(target=self._loop).start()

    def put(self, k, v):
        with self._lock:
            self._state[k] = v

    def _loop(self):
        return self._state.get("x")
"""),
    ('cl017_scoped_to_threaded_dirs', 'pkg/fed/mod.py', ['CL017'],
     """
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def start(self):
        threading.Thread(target=self._loop).start()

    def put(self, k, v):
        with self._lock:
            self._state[k] = v

    def size(self):
        with self._lock:
            return len(self._state)

    def _loop(self):
        return self._state.get("x")
"""),
    ('cl018_flags_opposite_nesting_order', 'pkg/comm/mod.py', ['CL018'],
     """
import threading

class Duo:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def fwd(self):
        with self._a_lock:
            with self._b_lock:
                pass

    def rev(self):
        with self._b_lock:
            with self._a_lock:
                pass
"""),
    ('cl018_quiet_on_consistent_order', 'pkg/comm/mod.py', ['CL018'],
     """
import threading

class Duo:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def fwd(self):
        with self._a_lock:
            with self._b_lock:
                pass

    def also_fwd(self):
        with self._a_lock:
            with self._b_lock:
                pass
"""),
    ('cl019_flags_sleep_and_broker_rpc_under_lock', 'pkg/comm/mod.py', ['CL019'],
     """
import time
import threading

from pkg.broker import BrokerClient

class S:
    def __init__(self):
        self._lock = threading.Lock()

    def spin(self):
        with self._lock:
            time.sleep(0.1)

    def refresh(self):
        with self._lock:
            return BrokerClient("h", 1, timeout=5.0)
"""),
    ('cl019_quiet_outside_lock_and_for_own_cv_wait', 'pkg/comm/mod.py', ['CL019'],
     """
import time
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition()
        self._ready = False

    def spin(self):
        time.sleep(0.1)
        with self._lock:
            pass

    def wait_ready(self):
        with self._cv:
            while not self._ready:
                self._cv.wait(1.0)
"""),
    ('cl019_suppression', 'pkg/comm/mod.py', ['CL019'],
     """
import time
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()

    def spin(self):
        with self._lock:
            time.sleep(0.1)  # colearn: noqa(CL019): test fixture
"""),
    ('cl020_flags_wait_outside_predicate_loop', 'pkg/comm/mod.py', ['CL020'],
     """
import threading

class W:
    def __init__(self):
        self._cv = threading.Condition()
        self._ready = False

    def wait_ready(self):
        with self._cv:
            self._cv.wait(1.0)
"""),
    ('cl020_quiet_in_while_loop_and_wait_for', 'pkg/comm/mod.py', ['CL020'],
     """
import threading

class W:
    def __init__(self):
        self._cv = threading.Condition()
        self._ready = False

    def wait_ready(self):
        with self._cv:
            while not self._ready:
                self._cv.wait(1.0)

    def wait_pred(self):
        with self._cv:
            self._cv.wait_for(lambda: self._ready, 1.0)
"""),
    ('cl021_flags_unlocked_iteration', 'pkg/comm/mod.py', ['CL021'],
     """
import threading

class T:
    def __init__(self):
        self._lock = threading.Lock()
        self._subs = {}

    def add(self, k, v):
        with self._lock:
            self._subs[k] = v

    def drop(self, k):
        with self._lock:
            self._subs.pop(k, None)

    def fanout(self):
        for s in self._subs.values():
            s()
"""),
    ('cl021_quiet_under_lock_and_for_snapshots', 'pkg/comm/mod.py', ['CL021'],
     """
import threading

class T:
    def __init__(self):
        self._lock = threading.Lock()
        self._subs = {}

    def add(self, k, v):
        with self._lock:
            self._subs[k] = v

    def drop(self, k):
        with self._lock:
            self._subs.pop(k, None)

    def fanout(self):
        with self._lock:
            for s in self._subs.values():
                s()
"""),
    ('cl021_quiet_under_lock_and_for_snapshots-1', 'pkg/comm/snap.py', ['CL021'],
     """
import threading

class T:
    def __init__(self):
        self._lock = threading.Lock()
        self._subs = {}

    def add(self, k, v):
        with self._lock:
            self._subs[k] = v

    def drop(self, k):
        with self._lock:
            self._subs.pop(k, None)

    def fanout(self):
        for s in list(self._subs.values()):
            s()
"""),
    ('cl021_comprehension_iteration_is_flagged', 'pkg/comm/mod.py', ['CL021'],
     """
import threading

class T:
    def __init__(self):
        self._lock = threading.Lock()
        self._subs = {}

    def add(self, k, v):
        with self._lock:
            self._subs[k] = v

    def drop(self, k):
        with self._lock:
            self._subs.pop(k, None)

    def names(self):
        return [k for k in self._subs]
"""),
]
