"""build-guest: the release-asset tree of the circuit apps (parity with the
reference's crates/build-guest/src/main.rs:186-394: chunk -> batch -> bundle
assets with per-circuit commitments, child-commitment bindings, vk dumps,
the bundle's canonical digests and the aggregate openVmVk.json).

`--with-evm-verifier` also writes `verifier.bin`, the PLONK verifier
bytecode of the SNARK wrapper, whose keys are set up on the card unless
`--device` names another device.

Usage:  python -m zkvm_prover_tpu_torch.bin.build_guest [--output releases/dev]
            [--with-evm-verifier] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

APPS = ["chunk", "batch", "bundle"]  # build order matters: child -> parent


def canonical_hex(data: bytes) -> str:
    """Canonical lowercase hex with 0x prefix (the digest_1/2.hex format,
    build-guest/src/main.rs:133-144)."""
    return "0x" + data.hex()


def generate_app_assets(output: Path) -> dict:
    from ..host.app import get_app

    vk_index = {}
    prev_commitments = None
    for name in APPS:
        app = get_app(name)
        app_dir = output / name
        app_dir.mkdir(parents=True, exist_ok=True)

        exe, vm = app.exe_commit(), app.vm_commit()
        commitments = {"exe": exe.hex(), "vm": vm.hex()}
        (app_dir / "commitments.json").write_text(json.dumps(commitments, indent=2))
        # parent circuits embed their child's commitments (the generated
        # child_commitments .rs files, main.rs:320-336)
        if prev_commitments is not None:
            (app_dir / "child_commitments.json").write_text(
                json.dumps(prev_commitments, indent=2))
        (app_dir / "app_vk.bin").write_bytes(app.vk_bytes())
        (app_dir / "app_vk.json").write_text(
            json.dumps({"app_name": name, "vk": app.vk_bytes().hex()}))
        if name == "bundle":
            # canonical digests the EVM verifier's constructor takes
            (app_dir / "digest_1.hex").write_text(canonical_hex(exe))
            (app_dir / "digest_2.hex").write_text(canonical_hex(vm))
        vk_index[name] = {
            "exe_commit": exe.hex(),
            "vm_commit": vm.hex(),
            "vk": app.vk_bytes().hex(),
        }
        prev_commitments = commitments

    (output / "openVmVk.json").write_text(json.dumps(vk_index, indent=2))
    return vk_index


def generate_evm_verifier_assets(output: Path, device=None) -> dict:
    """verifier.bin and the wrapper vk's metadata (the reference ships the
    generated contract as `verifier.bin` and simulates it,
    crates/verifier/src/evm.rs): the PLONK verifier bytecode of the wrapper
    circuit, its keys set up on `device` (None: the card)."""
    from ..ops.keccak import keccak256
    from ..snark import verifier_contract as vc, wrapper

    keys = wrapper.wrapper_keys(device=device)
    code = vc.generate_verifier(keys.vk)
    output.mkdir(parents=True, exist_ok=True)
    (output / "verifier.bin").write_bytes(code)
    meta = {
        "bytecode_keccak": keccak256(code).hex(),
        "bytecode_len": len(code),
        "wrapper_vk_digest": keys.vk.digest().hex(),
        "log_n": keys.vk.log_n,
        "n_public": keys.vk.n_public,
        "instance_layout": "12 acc + 2 digest + 32 pi (32-byte BE words)",
    }
    (output / "evm_verifier.json").write_text(json.dumps(meta, indent=2))
    return meta


def verify_assets(output: Path) -> bool:
    """The downloaded-vs-generated check (build-guest/src/verifier.rs:
    107-156): re-derive every asset and compare."""
    from ..host.app import get_app

    index = json.loads((output / "openVmVk.json").read_text())
    for name in APPS:
        app = get_app(name)
        if index[name]["vk"] != app.vk_bytes().hex():
            return False
        stored = json.loads((output / name / "commitments.json").read_text())
        if stored["exe"] != app.exe_commit().hex():
            return False
        if stored["vm"] != app.vm_commit().hex():
            return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", default="releases/dev")
    ap.add_argument("--with-evm-verifier", action="store_true",
                    help="also build verifier.bin (the wrapper keys' setup)")
    ap.add_argument("--device", default=None,
                    help="torch device of the wrapper's setup (default: the card)")
    args = ap.parse_args(argv)
    out = Path(args.output)
    index = generate_app_assets(out)
    if not verify_assets(out):
        raise SystemExit("the generated assets do not verify")
    payload = {"output": str(out), "apps": list(index)}
    if args.with_evm_verifier:
        meta = generate_evm_verifier_assets(out, args.device)
        payload["verifier_bin_len"] = meta["bytecode_len"]
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
