"""The port's own host modules (`oracle`, `witness.pack`, the block
witness modules, the trie planner, `native`) against the JAX package's,
whose copies they are: identical packed arrays, pools, hints and segment schedules, identical
digests, encodings, tries and proofs; disk caches that load in either
package, and tampered ones that both refuse. Also the port's public
surface against the JAX package's, name by name (`NOT_PORTED`)."""

import ast
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zk_state_proofs_tpu import native as jax_native
from zk_state_proofs_tpu import oracle as jax_oracle
from zk_state_proofs_tpu.witness import PackedProofs as JaxPackedProofs
from zk_state_proofs_tpu.witness import pack_proofs as jax_pack
from zk_state_proofs_tpu.witness.pack import PackingError as JaxPackingError
from zk_state_proofs_tpu.witness.pack import validate_node_pool as jax_validate_node_pool
from zk_state_proofs_tpu_torch import native, oracle
from zk_state_proofs_tpu_torch.witness import (PackedProofs, PackingError, pack_proofs,
                                               validate_node_pool)
from zk_state_proofs_tpu_torch.witness_bridge import account_entries, storage_world

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)

ARRAYS = ("nodes", "node_lens", "num_nodes", "roots", "key_nibbles", "key_lens")
REPO = Path(__file__).resolve().parent.parent

# The JAX package's public surface that the port leaves out by choice, each
# with its reason; ROADMAP queue 1 item 3 cites this dict. A key is a module
# of zk_state_proofs_tpu/ that has no counterpart file, "module::name", or
# "module::name(parameter)" (for `__all__`, "(parameter)" is a listed name).
NOT_PORTED = {
    "ops/keccak_pallas.py": "the Pallas keccak kernels (K1, K3); their counterparts "
                            "are csrc/keccak.cu and ops/keccak_cuda.py",
    "ops/mpt_pallas.py": "the Pallas walk kernel (K2) and its lax.cond re-run; their "
                         "counterparts are csrc/mpt_walk.cu and ops/mpt_cuda.py",
    "ops/select.py": "one-hot matmul fetches for a chip without a vector gather; the "
                     "port uses plain indexed loads",
    "ops/keccak.py::keccak_f1600(unroll)": "the unroll factor of XLA's fori_loop; the "
                                           "port's 24 rounds are a Python loop",
    "ops/rlp.py::decode_node_select(table)": "takes ops/select.py's one-hot word table; "
                                             "the port indexes the bytes",
    "ops/rlp.py::item_head": "a per-row helper that the JAX package vmaps; the port "
                             "batches the same work",
    "ops/rlp.py::node_items": "a per-row helper that the JAX package vmaps; the port "
                              "batches the same work",
    "ops/rlp.py::read_bytes32": "a per-row helper that the JAX package vmaps; the port "
                                "batches the same work",
    "ops/account.py::decode_account_one": "the per-row helper that decode_account "
                                          "vmaps; the port decodes the batch at once",
    **{f"ops/mpt.py::{fn}(conditional)":
       "picks lax.cond or straight-line XLA for the exact re-run, with the same "
       "results either way; the port decides the re-run on the card"
       for fn in ("walk_batch", "verify_proofs", "verify_proofs_pooled",
                  "verify_proofs_indexed", "verify_proofs_prehashed",
                  "verify_proofs_pool_stream")},
    "utils/profiling.py::tpu_trace": "jax.profiler's trace; the port's is "
                                     "utils.profiling.cuda_trace",
    "utils/__init__.py::tpu_trace": "jax.profiler's trace; the port's is cuda_trace",
    "utils/__init__.py::__all__(tpu_trace)": "jax.profiler's trace; the port's is "
                                             "cuda_trace",
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _surface(path, with_imports):
    """A module's public surface, read with `ast` (nothing is imported):
    {name: parameter names or None} for each public top-level def, class
    and assignment, each public method (and __init__) of a public class as
    "Class.method", `__all__` as the names it lists, and, `with_imports`,
    the names bound by top-level imports."""
    out = {}

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_"):
                    out[node.name] = _params(node)
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                out[node.name] = None
                for m in node.body:
                    if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and (m.name == "__init__" or not m.name.startswith("_"))):
                        out[f"{node.name}.{m.name}"] = _params(m)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        out["__all__"] = ast.literal_eval(node.value)
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and not n.id.startswith("_"):
                            out[n.id] = None
            elif isinstance(node, (ast.Import, ast.ImportFrom)) and with_imports:
                for a in node.names:
                    name = (a.asname or a.name).split(".")[0]
                    if not name.startswith("_"):
                        out[name] = None
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                for h in getattr(node, "handlers", ()):
                    visit(h.body)
                visit(node.orelse)

    visit(ast.parse(path.read_text()).body)
    return out


def _surface_gaps():
    """Every public name and parameter of zk_state_proofs_tpu/ that its
    counterpart module in zk_state_proofs_tpu_torch/ lacks, as NOT_PORTED's
    keys. The counterpart of native/__init__.py is native.py, of any other
    module the same relative path. Imports count as surface only in an
    __init__.py of the JAX package; in the port any top-level binding does."""
    jax_root, port_root = REPO / "zk_state_proofs_tpu", REPO / "zk_state_proofs_tpu_torch"
    gaps = set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        twin = port_root / ("native.py" if rel == "native/__init__.py" else rel)
        if not twin.exists():
            gaps.add(rel)
            continue
        have = _surface(twin, with_imports=True)
        for name, params in _surface(path, with_imports=path.name == "__init__.py").items():
            if name not in have:
                gaps.add(f"{rel}::{name}")
            elif params:
                gaps.update(f"{rel}::{name}({p})" for p in params
                            if p not in (have[name] or ()))
    return gaps


def check_surface_parity():
    """The port has every public name and parameter of the JAX package but
    NOT_PORTED's, and each of NOT_PORTED's keys still names one it lacks."""
    gaps = _surface_gaps()
    assert all(NOT_PORTED.values()), "a NOT_PORTED entry has no reason"
    assert not gaps - set(NOT_PORTED), f"the port lacks {sorted(gaps - set(NOT_PORTED))}"
    assert not set(NOT_PORTED) - gaps, \
        f"NOT_PORTED entries that name nothing missing: {sorted(set(NOT_PORTED) - gaps)}"


def _assert_same_pack(got, want):
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for g, w in zip(got.pool(), want.pool()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.pool_hints(), want.pool_hints())
    assert got.depth_segments() == want.depth_segments()
    assert got.pool_block_segments() == want.pool_block_segments()
    assert got.depth_segments(tile=32) == want.depth_segments(tile=32)
    assert got.pool_block_segments(tile=32) == want.pool_block_segments(tile=32)


@pytest.fixture(params=["native", "python"])
def host_path(request, monkeypatch):
    """The port's packer with its native library, and without it."""
    if request.param == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif not native.available():
        pytest.skip("the native host library does not build here")
    return request.param


def test_pack_matches_jax_on_headline_recipe(host_path, tmp_path):
    entries, _ = account_entries(256)
    packed = pack_proofs(entries, node_len=576)
    jpacked = jax_pack(entries, node_len=576)
    _assert_same_pack(packed, jpacked)
    # the disk cache: a witness saved by either package loads in the other
    # (the pool validated on load), with every array equal
    for save, load, name in ((packed.save, JaxPackedProofs.load, "port.npz"),
                             (jpacked.save, PackedProofs.load, "jax.npz")):
        save(tmp_path / name)
        _assert_same_pack(load(tmp_path / name), packed)
    validate_node_pool(packed.nodes, packed.node_lens, packed.num_nodes, *packed.pool())
    jax_validate_node_pool(packed.nodes, packed.node_lens, packed.num_nodes, *packed.pool())
    # three tampered caches, refused by both packages with the same message
    pool_nodes, pool_lens, pool_idx = packed.pool()
    flipped = pool_nodes.copy()
    flipped[1, 0] ^= 0xFF  # a real pool row (row 0 is the zero row)
    swapped = pool_idx.copy()
    d0, d1 = int(packed.num_nodes[0]) - 1, int(packed.num_nodes[1]) - 1
    swapped[0, d0], swapped[1, d1] = pool_idx[1, d1], pool_idx[0, d0]
    assert swapped[0, d0] != pool_idx[0, d0]  # two distinct leaves
    beyond = pool_idx.copy()
    beyond[3, 0] = pool_nodes.shape[0]
    for name, (pn, pi), prefix in (
            ("flipped", (flipped, pool_idx), "pool integrity violation"),
            ("swapped", (pool_nodes, swapped), "pool"),
            ("beyond", (pool_nodes, beyond), "pool_idx out of range")):
        bad = PackedProofs(*packed.astuple(), pool_nodes=pn, pool_lens=pool_lens, pool_idx=pi)
        bad.save(tmp_path / f"{name}.npz")
        with pytest.raises(PackingError, match=prefix) as got:
            PackedProofs.load(tmp_path / f"{name}.npz")
        with pytest.raises(JaxPackingError, match=prefix) as want:
            JaxPackedProofs.load(tmp_path / f"{name}.npz")
        assert str(got.value) == str(want.value), name


def test_pack_matches_jax_on_storage_world(host_path):
    w = storage_world(n_accounts=6, slots_per=3, slots_in_trie=24)
    for entries in (w.account_entries, w.storage_entries):
        _assert_same_pack(pack_proofs(entries), jax_pack(entries))
        _assert_same_pack(pack_proofs(entries, max_nodes=8, node_len=576),
                          jax_pack(entries, max_nodes=8, node_len=576))
    ap, sp = w.pack()
    assert ap.batch == 6 and sp.batch == 18
    assert sp.nodes.shape[2] % 4 == 0
    assert sp.nodes.shape[2] >= max(len(n) for _, p, _ in w.storage_entries for n in p) + 4


def test_oracle_keccak_rlp_and_trie_match_jax(monkeypatch):
    rng = np.random.default_rng(11)
    msgs = []
    for n in (0, 1, 55, 135, 136, 137, 300, 2092):
        msg = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert oracle.keccak256(msg) == jax_oracle.keccak256(msg)
        assert native.keccak256(msg) == oracle.keccak256(msg)
        msgs.append(msg)
    # keccak256_batch with the native library, without it, and with a
    # stale build that lacks the symbol
    want = [oracle.keccak256(m) for m in msgs]
    assert jax_native.keccak256_batch(msgs) == want
    for lib in ("built", None, object()):
        with monkeypatch.context() as m:
            if lib != "built":
                m.setattr(native, "get_lib", lambda: lib)
            assert native.keccak256_batch(msgs) == want, lib
            assert native.keccak256_batch([]) == []
    _check_ops_and_meter(rng)
    check_surface_parity()
    items = [b"", b"\x01", b"\x7f\x80", [b"ab" * 40, [b"c"]], 10**20]
    enc = oracle.rlp.encode([oracle.rlp.int_to_min_bytes(x) if isinstance(x, int) else x
                             for x in items])
    assert enc == jax_oracle.rlp.encode([jax_oracle.rlp.int_to_min_bytes(x)
                                         if isinstance(x, int) else x for x in items])
    assert oracle.rlp.decode(enc) == jax_oracle.rlp.decode(enc)
    ours, theirs = oracle.EthTrie(), jax_oracle.EthTrie()
    keys = [oracle.keccak256(b"host-%d" % i)[: 6 + i % 27] for i in range(60)]
    for i, k in enumerate(keys):
        ours.insert(k, oracle.rlp.encode_int(i + 1))
        theirs.insert(k, jax_oracle.rlp.encode_int(i + 1))
    assert ours.root_hash() == theirs.root_hash()
    for k in keys[::7] + [b"\xee" * 8]:
        assert ours.get_proof(k) == theirs.get_proof(k)
    assert oracle.EMPTY_ROOT == jax_oracle.EMPTY_ROOT
    assert oracle.bytes_to_nibbles(b"\xab\x01") == jax_oracle.bytes_to_nibbles(b"\xab\x01")
    proof = ours.get_proof(keys[3])
    assert oracle.verify_merkle_proof(ours.root_hash(), proof, keys[3]) == \
        jax_oracle.verify_merkle_proof(theirs.root_hash(), proof, keys[3])
    with pytest.raises(oracle.MissingKeyError):
        oracle.verify_merkle_proof(ours.root_hash(), ours.get_proof(b"\xee" * 8), b"\xee" * 8)
    with pytest.raises(oracle.TrieError):
        oracle.verify_merkle_proof(ours.root_hash(), proof[:-1], keys[3])


def _check_ops_and_meter(rng):
    """The `ops` re-exports and `Meter.dump` give the JAX package's."""
    from zk_state_proofs_tpu import ops as jax_ops
    from zk_state_proofs_tpu.utils.profiling import Meter as JaxMeter
    from zk_state_proofs_tpu_torch import ops
    from zk_state_proofs_tpu_torch.ops import keccak256, keccak256_fixed, keccak_f1600
    from zk_state_proofs_tpu_torch.utils.profiling import Meter

    assert ops.__all__ == jax_ops.__all__
    data = rng.integers(0, 256, (5, 300), dtype=np.uint8)
    lens = np.asarray([0, 55, 136, 137, 300], np.int32)
    got = keccak256(torch.from_numpy(data), torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ops.keccak256(data, lens)))
    assert [bytes(d) for d in got] == [oracle.keccak256(r[:n].tobytes())
                                       for r, n in zip(data, lens)]
    # the shapes of the call above, so that JAX reuses its compiled rounds
    np.testing.assert_array_equal(keccak256_fixed(torch.from_numpy(data)).numpy(),
                                  np.asarray(jax_ops.keccak256_fixed(data)))
    hi, lo = rng.integers(0, 1 << 32, (2, 25, 5), dtype=np.uint32)
    th, tl = keccak_f1600(torch.from_numpy(hi.astype(np.int64)),
                          torch.from_numpy(lo.astype(np.int64)))
    jh, jl = jax_ops.keccak_f1600(hi, lo)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh, np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl, np.int64))

    ours, theirs = Meter(), JaxMeter()
    for step in ((4096, 9114, 4_800_000, 0.25), (1365, 3000, 1_600_000, 0.125)):
        ours.record(*step)
        theirs.record(*step)
    a, b = io.StringIO(), io.StringIO()
    ours.dump(file=a)
    theirs.dump(file=b)
    assert a.getvalue() == b.getvalue() and a.getvalue().count("\n") == 1
    assert json.loads(a.getvalue()) == json.loads(b.getvalue()) == ours.summary()


def test_block_host_copies_match_jax(monkeypatch, tmp_path):
    """The port's `witness.encoding`, `types`, `builders` and `fixtures`
    give the JAX package's bytes, roots and proofs; its `witness.models`,
    `rpc`, `networks`, `constants`, the account and storage builders, the
    fixture recorders and `utils.errors` / `config` / `profiling.timed`
    behave as the originals (and `profiling.cuda_trace` writes a Chrome
    trace of a CPU call), offline (a stub transport stands in for
    the network)."""
    from pathlib import Path

    from zk_state_proofs_tpu.witness import builders as jbuilders
    from zk_state_proofs_tpu.witness import encoding as jencoding
    from zk_state_proofs_tpu.witness import fixtures as jfixtures
    from zk_state_proofs_tpu.witness import types as jtypes
    from zk_state_proofs_tpu_torch.witness import builders, encoding, fixtures, types

    fx = fixtures.synthetic_block(num_txs=12, seed=4)
    assert fx == jfixtures.synthetic_block(num_txs=12, seed=4)
    block, receipts = fx["block"], fx["receipts"]
    assert {encoding.tx_type(tx) for tx in block["transactions"]} >= {0, 2}
    for tx in block["transactions"]:
        assert encoding.encode_transaction(tx) == jencoding.encode_transaction(tx)
    for r in receipts:
        assert encoding.encode_receipt(r) == jencoding.encode_receipt(r)
        for log in r["logs"]:
            assert encoding.encode_log(log) == jencoding.encode_log(log)
    path = Path(__file__).resolve().parent.parent / "fixtures" / "mainnet_headers.json"
    headers = fixtures.load_fixture(path)
    assert headers == jfixtures.load_fixture(path)
    for name in ("genesis", "block1"):
        assert encoding.encode_header(headers[name]) == jencoding.encode_header(headers[name])
        assert encoding.block_hash(headers[name]).hex() == headers[name]["hash"][2:]
    assert fixtures.ERC20_TRANSFER_TOPIC == jfixtures.ERC20_TRANSFER_TOPIC

    pairs = [(builders.get_all_transaction_proof_inputs(block),
              jbuilders.get_all_transaction_proof_inputs(block)),
             (builders.get_all_receipt_proof_inputs(block, receipts),
              jbuilders.get_all_receipt_proof_inputs(block, receipts)),
             ([builders.get_transaction_proof_input(block, 3),
               builders.get_receipt_proof_input(block, receipts, 5)],
              [jbuilders.get_transaction_proof_input(block, 3),
               jbuilders.get_receipt_proof_input(block, receipts, 5)])]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.to_borsh() == b.to_borsh()
            assert types.MerkleProofInput.from_borsh(b.to_borsh()) == a
    assert builders.build_receipt_trie(receipts).root_hash() == \
        jbuilders.build_receipt_trie(receipts).root_hash()
    storage = dict(account_proof=[b"\x01" * 40], storage_proofs=[[b"\x02" * 33], []],
                   root_hash=b"\x03" * 32, account_key=b"\x04" * 32,
                   storage_keys=[b"\x05" * 32, b"\x06"], address_keccak=b"\x07" * 32)
    raw = types.StorageProofInput(**storage).to_borsh()
    assert raw == jtypes.StorageProofInput(**storage).to_borsh()
    assert types.StorageProofInput.from_borsh(raw) == types.StorageProofInput(**storage)
    # the trie planner's copy gives the original's plans
    from zk_state_proofs_tpu.witness import trie_plan as jtrie_plan
    from zk_state_proofs_tpu_torch.witness import trie_plan

    values = [encoding.encode_receipt(r) for r in receipts]
    dogs = [(b"do", b"verb"), (b"dog", b"puppy"), (b"doge", b"coin"), (b"horse", b"stallion")]
    for ours, theirs in ((trie_plan.plan_index_trie(values), jtrie_plan.plan_index_trie(values)),
                         (trie_plan.plan_trie(dogs), jtrie_plan.plan_trie(dogs)),
                         (trie_plan.plan_trie([]), jtrie_plan.plan_trie([]))):
        assert (ours.root_id, ours.total_nodes, ours.root_is_empty, ours.num_levels) == (
            theirs.root_id, theirs.total_nodes, theirs.root_is_empty, theirs.num_levels)
        for a, b in zip(ours.levels, theirs.levels):
            for f in ("templates", "lengths", "node_ids", "hole_src", "hole_off"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    bad = dict(block["transactions"][0])
    bad.pop("nonce")
    with pytest.raises(builders.WitnessError):
        builders.build_transaction_trie([bad])
    with pytest.raises(jbuilders.WitnessError):
        jbuilders.build_transaction_trie([bad])
    with pytest.raises(builders.WitnessError):
        builders.get_receipt_proof_input(dict(block, receiptsRoot="0x" + "00" * 32),
                                         receipts, 0)

    # the host modules of the CLI: typed RPC models on recorded responses
    from tests.test_mainnet_getproof import _synthetic_getproof_fixture
    from tests.test_models_rpc import OP_BLOCK, PROOF_RESPONSE
    from zk_state_proofs_tpu.utils import config as jconfig
    from zk_state_proofs_tpu.utils import errors as jerrors
    from zk_state_proofs_tpu.witness import constants as jconstants
    from zk_state_proofs_tpu.witness import models as jmodels
    from zk_state_proofs_tpu.witness import networks as jnetworks
    from zk_state_proofs_tpu.witness import rpc as jrpc
    from zk_state_proofs_tpu_torch.utils import config, errors, profiling
    from zk_state_proofs_tpu_torch.witness import constants, models, networks, rpc

    from dataclasses import asdict

    arb = {"hash": "0x" + "cd" * 32, "number": "0x12d687", "stateRoot": "0x" + "ef" * 32}
    for name, resp in (("OpBlock", OP_BLOCK), ("AccountProofResult", PROOF_RESPONSE),
                       ("ArbBlock", arb)):
        assert asdict(getattr(models, name).from_rpc(resp)) == \
            asdict(getattr(jmodels, name).from_rpc(resp)), name
    for bad in ({**OP_BLOCK, "stateRoot": "0xzz"},
                {**OP_BLOCK, "transactions": [{"type": "0x2", "chainId": "0x1"}]}):
        with pytest.raises(builders.WitnessError):
            models.OpBlock.from_rpc(bad)
        with pytest.raises(jbuilders.WitnessError):
            jmodels.OpBlock.from_rpc(bad)
    with pytest.raises(builders.WitnessError, match="accountProof"):
        models.AccountProofResult.from_rpc({**PROOF_RESPONSE, "accountProof": "0xff"})
    # the account and storage builders on the recorded response and on a
    # getProof-schema fixture
    addr = PROOF_RESPONSE["address"]
    assert builders.get_account_proof_input(PROOF_RESPONSE, b"\x00" * 32, addr).to_borsh() == \
        jbuilders.get_account_proof_input(PROOF_RESPONSE, b"\x00" * 32, addr).to_borsh()
    gp, _ = _synthetic_getproof_fixture()
    args = (gp["proof"], encoding._data(gp["block"]["stateRoot"]), gp["address"],
            gp["storageKeys"])
    ours = builders.get_storage_proof_input(*args)
    assert ours.to_borsh() == jbuilders.get_storage_proof_input(*args).to_borsh()
    assert ours.storage_keys == [b"\x00" * 32] and ours.account_key == \
        oracle.keccak256(encoding._data(gp["address"]))
    with pytest.raises(builders.WitnessError, match="missing"):
        builders.get_storage_proof_input(*args[:3], ["0x5"])
    # RPC clients, networks and the recorders through a stub transport
    calls = []

    def transport(url, payload):
        calls.append((url, payload["method"], payload["params"]))
        method = payload["method"]
        if method == "eth_getBlockByHash":
            return {"result": block}
        if method == "eth_getBlockReceipts":
            return {"result": receipts}
        if method == "eth_getBlockByNumber":
            return {"result": gp["block"]}
        if method == "eth_getProof":
            return {"result": gp["proof"]}
        return {"error": {"code": -32601, "message": "no such method"}}

    for net in ("ethereum", "optimism", "arbitrum"):
        got = networks.client_for(networks.NetworkEvm(net), url="http://stub", transport=transport)
        want = jnetworks.client_for(jnetworks.NetworkEvm(net), url="http://stub",
                                    transport=transport)
        assert type(got).__name__ == type(want).__name__ and got.url == want.url
    client = rpc.EthereumClient(url="http://stub", transport=transport)
    jclient = jrpc.EthereumClient(url="http://stub", transport=transport)
    path, jpath = tmp_path / "block.json", tmp_path / "jblock.json"
    assert fixtures.record_block_fixture(client, block["hash"], path) == \
        jfixtures.record_block_fixture(jclient, block["hash"], jpath)
    assert path.read_text() == jpath.read_text()
    assert fixtures.load_fixture(path) == {"block": block, "receipts": receipts}
    assert fixtures.record_proof_fixture(client, gp["address"], gp["storageKeys"],
                                         path=path) == \
        jfixtures.record_proof_fixture(jclient, gp["address"], gp["storageKeys"], path=jpath)
    assert path.read_text() == jpath.read_text()
    eth = networks.NetworkEvm.ETHEREUM
    assert networks.get_storage_proof_inputs(client, gp["address"], gp["storageKeys"],
                                             eth).to_borsh() == ours.to_borsh()
    assert networks.get_receipt_proof_inputs(client, block["hash"], 2, eth).to_borsh() == \
        jnetworks.get_receipt_proof_inputs(jclient, block["hash"], 2,
                                           jnetworks.NetworkEvm.ETHEREUM).to_borsh()
    with pytest.raises(builders.WitnessError):
        networks.get_transaction_proof_inputs(client, block["hash"], 0,
                                              networks.NetworkEvm.ARBITRUM)
    with pytest.raises(rpc.RpcError, match="no such method"):
        client.call("eth_chainId", [])
    with pytest.raises(jrpc.RpcError, match="no such method"):
        jclient.call("eth_chainId", [])
    monkeypatch.delenv("INFURA", raising=False)
    with pytest.raises(RuntimeError):
        rpc.EthereumClient(transport=transport)
    # constants, errors and the ZKP_ environment overrides
    assert {k: v for k, v in vars(constants).items() if k.isupper()} == \
        {k: v for k, v in vars(jconstants).items() if k.isupper()}
    assert rpc.ETHEREUM_RPC_URL == jrpc.ETHEREUM_RPC_URL
    assert errors.__all__ == jerrors.__all__
    assert errors.VerificationError is oracle.TrieError
    assert issubclass(errors.MissingKeyError, errors.VerificationError)
    assert errors.PackingError.__name__ == jerrors.PackingError.__name__
    monkeypatch.setenv("ZKP_BATCH_SIZE", "1024")
    monkeypatch.setenv("ZKP_MESH_AXIS", "rows")
    monkeypatch.setenv("INFURA", "k-123")
    for kw in ({}, {"batch_size": 64}):
        assert vars(config.Config.from_env(**kw)) == vars(jconfig.Config.from_env(**kw))
    cfg = config.Config.from_env(batch_size=64)
    assert (cfg.batch_size, cfg.mesh_axis, cfg.infura_key) == (64, "rows", "k-123")
    monkeypatch.setenv("ZKP_INFURA_KEY", "k-env")
    assert config.Config.from_env().infura_key == "k-env"
    holder = {}
    with profiling.timed(holder, "t", sync=torch.zeros(1)):
        pass
    assert holder["t"] >= 0
    with profiling.cuda_trace(tmp_path / "trace"):
        torch.arange(64).reshape(8, 8).sum(0)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events), events[:5]
