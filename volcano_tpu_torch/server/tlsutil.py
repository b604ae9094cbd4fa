"""TLS + bearer-token plumbing for the wire boundary.

The reference webhook manager and apiserver speak TLS with cert
plumbing (cmd/webhook-manager/, pkg/webhooks/config/); this module is
the rebuild's equivalent for the state server, webhook manager, and
every client (scheduler, controllers, vtpctl): self-signed cert
generation for dev/test clusters, ssl.SSLContext construction for both
sides, and constant-time bearer-token comparison for mutating routes.

One shared cluster token authenticates every component to every other
(the join-token model); cert verification pins the server identity.
"""

from __future__ import annotations

import datetime
import hmac
import ipaddress
import os
import ssl
from typing import Optional, Tuple


def generate_self_signed(cert_path: str, key_path: str,
                         hosts: Tuple[str, ...] = ("127.0.0.1",
                                                   "localhost"),
                         days: int = 365) -> None:
    """Write a self-signed server certificate + key (PEM).  The same
    cert file doubles as the clients' CA bundle (self-signed ==
    self-CA), mirroring the reference's gen-admission-secret flow.

    Uses the `cryptography` package when importable, else falls back
    to the system `openssl` binary (deploy images bake the ML stack,
    not pyca/cryptography — the cert material is identical)."""
    try:
        from cryptography import x509  # noqa: F401
    except ImportError:
        _generate_self_signed_openssl(cert_path, key_path, hosts, days)
        return
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "volcano-tpu")])
    alt_names = []
    for h in hosts:
        try:
            alt_names.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            alt_names.append(x509.DNSName(h))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.SubjectAlternativeName(alt_names),
                           critical=False)
            .add_extension(x509.BasicConstraints(ca=True,
                                                 path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    # key first, restrictive mode
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key_pem)
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))


def _generate_self_signed_openssl(cert_path: str, key_path: str,
                                  hosts: Tuple[str, ...],
                                  days: int) -> None:
    """`openssl req -x509` fallback producing the same PEM pair (SANs
    for every host, CA:TRUE so the cert self-anchors as the clients'
    bundle).  Key lands first with a restrictive mode, like the
    library path."""
    import shutil
    import subprocess
    openssl = shutil.which("openssl")
    if openssl is None:
        raise RuntimeError(
            "cannot generate a self-signed cert: neither the "
            "`cryptography` package nor an `openssl` binary is "
            "available")
    alt = []
    for h in hosts:
        try:
            ipaddress.ip_address(h)
            alt.append(f"IP:{h}")
        except ValueError:
            alt.append(f"DNS:{h}")
    # pre-create the key with a restrictive mode so openssl's write
    # lands on 0600 (openssl honors existing modes on POSIX)
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    os.close(fd)
    # NOTE: no explicit basicConstraints — `req -x509` already emits
    # CA:TRUE, and a duplicated extension makes OpenSSL-backed clients
    # reject the chain with `unknown ca`
    cmd = [openssl, "req", "-x509", "-newkey", "rsa:2048", "-nodes",
           "-keyout", key_path, "-out", cert_path,
           "-days", str(days), "-subj", "/CN=volcano-tpu",
           "-addext", f"subjectAltName={','.join(alt)}"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"openssl cert generation failed: {proc.stderr[-500:]}")
    os.chmod(key_path, 0o600)


def server_ssl_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def client_ssl_context(ca_cert: str = "",
                       insecure: bool = False
                       ) -> Optional[ssl.SSLContext]:
    """Context for https:// clients: verify against ca_cert when
    given; insecure=True skips verification (encrypted, unpinned —
    kubectl's insecure-skip-tls-verify).  None for plain http."""
    if insecure:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    if ca_cert:
        return ssl.create_default_context(cafile=ca_cert)
    return None


def token_ok(configured: str, authorization_header: str) -> bool:
    """Constant-time check of 'Authorization: Bearer <token>'.  An
    empty configured token disables auth (dev mode)."""
    if not configured:
        return True
    return hmac.compare_digest(authorization_header or "",
                               f"Bearer {configured}")


def load_token(token: str = "", token_file: str = "") -> str:
    if token:
        return token
    if token_file:
        with open(token_file, encoding="utf-8") as f:
            return f.read().strip()
    return ""
