"""Command-line driver (port of `zk_state_proofs_tpu.__main__`).

The reference's host binary is a todo!() stub (reference:
prover/src/bin/main.rs:3-5) whose real flows live in its integration
tests; here they are first-class commands:

  python -m zk_state_proofs_tpu_torch verify-tx       --fixture block.json --index 15
  python -m zk_state_proofs_tpu_torch verify-receipts --fixture block.json --erc20
  python -m zk_state_proofs_tpu_torch verify-storage  --fixture proof.json
  python -m zk_state_proofs_tpu_torch record-block    --network ethereum --hash 0x...
  python -m zk_state_proofs_tpu_torch record-proof    --network ethereum --address 0x... --slot 0x...
  python -m zk_state_proofs_tpu_torch diagnose        --fixture block.json --kind tx
  python -m zk_state_proofs_tpu_torch selftest

The commands that verify take `--device`: "cuda" (the default: kernels K1
and K2, an error without a card) or "cpu" (their plain versions). The JSON
on stdout and the exit codes are the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_block_fixture(path):
    from .witness import load_fixture

    fx = load_fixture(path)
    return fx["block"], fx.get("receipts", [])


def cmd_verify_tx(args):
    from .models import verify_block_transactions

    block, _ = _load_block_fixture(args.fixture)
    indices = None if args.index is None else [args.index]
    res = verify_block_transactions(block, indices=indices, device=args.device)
    print(json.dumps({"counts": res.counts(), "batch": len(res.status)}))
    return 0 if res.all_found else 1


def cmd_verify_receipts(args):
    from .models import verify_block_receipts

    block, receipts = _load_block_fixture(args.fixture)
    res, transfers = verify_block_receipts(block, receipts, device=args.device)
    out = {"counts": res.counts(), "batch": len(res.status)}
    if args.erc20:
        out["erc20_transfers"] = [
            {
                "token": "0x" + t.token.hex(),
                "from": "0x" + t.sender.hex(),
                "to": "0x" + t.receiver.hex(),
                "amount": t.amount,
                "tx_index": t.tx_index,
            }
            for t in transfers
        ]
    print(json.dumps(out))
    return 0 if res.all_found else 1


def cmd_verify_storage(args):
    from .witness import load_fixture, pack_proofs
    from .witness.builders import get_storage_proof_input
    from .witness.encoding import _data
    from .models import verify_storage_grouped
    from .ops import mpt

    fx = load_fixture(args.fixture)
    # offline anchor: when the fixture carries the block's published hash,
    # the FULL header must hash to it before its stateRoot is trusted
    # (same chain as tests/test_mainnet_getproof.py; the hash itself is
    # checkable against any public block explorer)
    if fx["block"].get("hash"):
        from .witness.encoding import block_hash

        got = block_hash(fx["block"])
        want = _data(fx["block"]["hash"])
        if got != want:
            print(json.dumps({
                "error": "header-anchor mismatch",
                "computed": "0x" + got.hex(),
                "pinned": "0x" + want.hex()}))
            return 1
    state_root = _data(fx["block"]["stateRoot"])
    inp = get_storage_proof_input(fx["proof"], state_root, fx["address"], fx["storageKeys"])
    b = len(inp.storage_proofs)
    # the reference's exact input shape: ONE account row, a vector of
    # slot proofs mapped to it (crypto-ops/src/types.rs:12-19)
    a_packed = pack_proofs([(inp.root_hash, inp.account_proof, inp.account_key)])
    s_packed = pack_proofs(
        [(b"\x00" * 32, p, k) for p, k in zip(inp.storage_proofs, inp.storage_keys)]
    )
    slots = np.stack([np.frombuffer(k, np.uint8) for k in inp.storage_keys])
    res = verify_storage_grouped(a_packed, s_packed, slots,
                                 np.zeros(b, np.int32), device=args.device)
    ok = (res.account_status == mpt.FOUND).all() and (res.slot_status == mpt.FOUND).all()
    print(json.dumps({
        "account_found": bool((res.account_status == mpt.FOUND).all()),
        "slots": [
            {"slot": "0x" + inp.storage_keys[i].hex(),
             "value": "0x" + res.slot_value(i).hex(),
             "status": int(res.slot_status[i])}
            for i in range(b)
        ],
    }))
    return 0 if ok else 1


def cmd_record_block(args):
    from .witness import record_block_fixture
    from .witness.networks import NetworkEvm, client_for

    client = client_for(NetworkEvm(args.network), url=args.url)
    record_block_fixture(client, args.hash, args.out)
    print(f"recorded {args.out}")
    return 0


def cmd_record_proof(args):
    from .witness import record_proof_fixture
    from .witness.networks import NetworkEvm, client_for

    client = client_for(NetworkEvm(args.network), url=args.url)
    record_proof_fixture(client, args.address, args.slot or [], args.tag, args.out)
    print(f"recorded {args.out}")
    return 0


def cmd_diagnose(args):
    """Verify a recorded block's tx or receipt proofs WITH per-proof
    INVALID reason codes (mpt.REASON_NAMES) — the triage surface for the
    reference's distinct panic messages (crypto-ops/src/lib.rs:14,22).
    On the card the reasons come from the walk kernel's latch (K2)."""
    from .models import diagnose_batch
    from .ops import mpt
    from .witness.builders import (
        get_all_receipt_proof_inputs,
        get_all_transaction_proof_inputs,
    )
    from .witness.pack import pack_proofs

    block, receipts = _load_block_fixture(args.fixture)
    if args.kind == "receipts":
        inputs = get_all_receipt_proof_inputs(block, receipts)
    else:
        inputs = get_all_transaction_proof_inputs(block)
    entries = [i.as_entry() for i in inputs]
    node_len = max(len(n) for _, p, _ in entries for n in p)
    packed = pack_proofs(entries, node_len=node_len, key_nibbles=8)
    res = diagnose_batch(packed, max_value_len=node_len, device=args.device)
    bad = [
        {"index": i, "status": int(res.status[i]),
         "reason": mpt.REASON_NAMES[int(res.reasons[i])]}
        for i in range(len(res.status)) if res.status[i] != mpt.FOUND
    ]
    print(json.dumps({"counts": res.counts(), "failures": bad}))
    return 0 if not bad else 1


def cmd_selftest(args):
    """Offline end-to-end check on a synthetic block."""
    from .witness import synthetic_block
    from .models import verify_block_receipts, verify_block_transactions

    fx = synthetic_block(num_txs=args.txs, seed=0)
    res_tx = verify_block_transactions(fx["block"], device=args.device)
    res_r, transfers = verify_block_receipts(fx["block"], fx["receipts"], device=args.device)
    ok = res_tx.all_found and res_r.all_found
    print(json.dumps({
        "transactions": res_tx.counts(),
        "receipts": res_r.counts(),
        "erc20_transfers": len(transfers),
        "ok": ok,
    }))
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zk_state_proofs_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    on = argparse.ArgumentParser(add_help=False)
    on.add_argument("--device", default="cuda",
                    help='"cuda" (the default; needs a card) or "cpu"')

    s = sub.add_parser("verify-tx", parents=[on],
                       help="verify transaction proofs of a recorded block")
    s.add_argument("--fixture", required=True)
    s.add_argument("--index", type=int)
    s.set_defaults(fn=cmd_verify_tx)

    s = sub.add_parser("verify-receipts", parents=[on],
                       help="verify receipt proofs of a recorded block")
    s.add_argument("--fixture", required=True)
    s.add_argument("--erc20", action="store_true", help="extract ERC20 transfers")
    s.set_defaults(fn=cmd_verify_receipts)

    s = sub.add_parser("verify-storage", parents=[on],
                       help="verify an account+storage proof fixture")
    s.add_argument("--fixture", required=True)
    s.set_defaults(fn=cmd_verify_storage)

    s = sub.add_parser("record-block", help="record a block fixture over RPC")
    s.add_argument("--network", default="ethereum", choices=["ethereum", "optimism", "arbitrum"])
    s.add_argument("--hash", required=True)
    s.add_argument("--url")
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_record_block)

    s = sub.add_parser("record-proof", help="record an eth_getProof fixture over RPC")
    s.add_argument("--network", default="ethereum", choices=["ethereum", "optimism", "arbitrum"])
    s.add_argument("--address", required=True)
    s.add_argument("--slot", action="append")
    s.add_argument("--tag", default="latest")
    s.add_argument("--url")
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_record_proof)

    s = sub.add_parser("diagnose", parents=[on],
                       help="verify a block's proofs with INVALID reason codes")
    s.add_argument("--fixture", required=True)
    s.add_argument("--kind", default="tx", choices=["tx", "receipts"])
    s.set_defaults(fn=cmd_diagnose)

    s = sub.add_parser("selftest", parents=[on],
                       help="offline end-to-end check (synthetic block)")
    s.add_argument("--txs", type=int, default=16)
    s.set_defaults(fn=cmd_selftest)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
