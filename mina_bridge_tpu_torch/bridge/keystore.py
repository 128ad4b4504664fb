"""Ethereum V3 keystore wallets + wallet selection policy.

Parity with the reference's `utils/wallet.rs:24-64`: Holesky wallets come
from an encrypted keystore (password prompted on the TTY) or a raw
private key — defining both is an error — while devnet falls back to the
deterministic funded Anvil key. Key material hygiene mirrors the
reference's `zeroize`: secrets are kept in bytearrays and wiped in
`finally` blocks (CPython offers no stronger guarantee without native
allocations; documented deviation).

Keystore format: the standard Web3 Secret Storage v3 JSON
(scrypt or pbkdf2-hmac-sha256 KDF, aes-128-ctr cipher, keccak-256 MAC
over derived_key[16:32] || ciphertext).

The port's own copy of mina_bridge_tpu/bridge/keystore.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import getpass
import hashlib
import json
import os
import pathlib
import secrets

from ..utils.constants import ANVIL_PRIVATE_KEY
from .keccak import keccak256


def _wipe(buf: bytearray) -> None:
    for i in range(len(buf)):
        buf[i] = 0


def _derive_key(crypto: dict, password: bytes) -> bytearray:
    kdf = crypto["kdf"]
    params = crypto["kdfparams"]
    salt = bytes.fromhex(params["salt"])
    if kdf == "scrypt":
        return bytearray(
            hashlib.scrypt(
                password,
                salt=salt,
                n=params["n"],
                r=params["r"],
                p=params["p"],
                dklen=params["dklen"],
                maxmem=1 << 30,
            )
        )
    if kdf == "pbkdf2":
        assert params.get("prf", "hmac-sha256") == "hmac-sha256"
        return bytearray(
            hashlib.pbkdf2_hmac(
                "sha256", password, salt, params["c"], dklen=params["dklen"]
            )
        )
    raise ValueError(f"unsupported kdf {kdf!r}")


def _aes128ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    cipher = Cipher(algorithms.AES(bytes(key)), modes.CTR(bytes(iv)))
    enc = cipher.encryptor()
    return enc.update(data) + enc.finalize()


def decrypt_keystore(path: str | pathlib.Path, password: str) -> int:
    """Decrypt a V3 keystore file -> private key int. Raises ValueError
    on a bad password (MAC mismatch)."""
    ks = json.loads(pathlib.Path(path).read_text())
    if int(ks.get("version", 0)) != 3:
        raise ValueError("only V3 keystores are supported")
    crypto = ks["crypto"] if "crypto" in ks else ks["Crypto"]
    pw = bytearray(password.encode())
    dk = bytearray()
    try:
        dk = _derive_key(crypto, bytes(pw))
        ct = bytes.fromhex(crypto["ciphertext"])
        mac = keccak256(bytes(dk[16:32]) + ct)
        if mac.hex() != crypto["mac"].lower():
            raise ValueError("invalid password (MAC mismatch)")
        if crypto["cipher"] != "aes-128-ctr":
            raise ValueError(f"unsupported cipher {crypto['cipher']!r}")
        iv = bytes.fromhex(crypto["cipherparams"]["iv"])
        pk = bytearray(_aes128ctr(bytes(dk[:16]), iv, ct))
        try:
            return int.from_bytes(bytes(pk), "big")
        finally:
            _wipe(pk)
    finally:
        _wipe(dk)
        _wipe(pw)


def encrypt_keystore(
    private_key: int,
    password: str,
    path: str | pathlib.Path | None = None,
    kdf: str = "scrypt",
    work: int | None = None,
) -> dict:
    """Produce (and optionally write) a V3 keystore JSON for the key."""
    salt = secrets.token_bytes(32)
    iv = secrets.token_bytes(16)
    if kdf == "scrypt":
        n = work or (1 << 13)
        kdfparams = {"n": n, "r": 8, "p": 1, "dklen": 32, "salt": salt.hex()}
        dk = hashlib.scrypt(
            password.encode(), salt=salt, n=n, r=8, p=1, dklen=32,
            maxmem=1 << 30,
        )
    elif kdf == "pbkdf2":
        c = work or 262_144
        kdfparams = {
            "c": c, "dklen": 32, "prf": "hmac-sha256", "salt": salt.hex(),
        }
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, c, dklen=32)
    else:
        raise ValueError(f"unsupported kdf {kdf!r}")
    ct = _aes128ctr(dk[:16], iv, private_key.to_bytes(32, "big"))
    ks = {
        "version": 3,
        "crypto": {
            "cipher": "aes-128-ctr",
            "cipherparams": {"iv": iv.hex()},
            "ciphertext": ct.hex(),
            "kdf": kdf,
            "kdfparams": kdfparams,
            "mac": keccak256(dk[16:32] + ct).hex(),
        },
    }
    if path is not None:
        p = pathlib.Path(path)
        p.write_text(json.dumps(ks))
        os.chmod(p, 0o600)
    return ks


def get_wallet(
    network: str,
    keystore_path: str | None = None,
    private_key: str | int | None = None,
    password_prompt=None,
):
    """Wallet selection policy (reference utils/wallet.rs:24-64).

    * both keystore and key set -> error;
    * holesky: keystore (password prompted) or raw key, else error;
    * devnet/anvil: the deterministic funded Anvil key.
    """
    from .eth import Wallet

    if keystore_path is not None and private_key is not None:
        raise ValueError(
            "Both keystore and private key env. variables are defined. "
            "Choose only one."
        )
    if network == "holesky":
        if keystore_path is not None:
            prompt = password_prompt or (
                lambda: getpass.getpass("Please enter your keystore password:")
            )
            return Wallet(decrypt_keystore(keystore_path, prompt()))
        if private_key is not None:
            if isinstance(private_key, str):
                return Wallet.from_hex(private_key)
            return Wallet(private_key)
        raise ValueError(
            "Holesky chain was selected but couldn't find KEYSTORE_PATH "
            "or PRIVATE_KEY."
        )
    return Wallet(ANVIL_PRIVATE_KEY)
