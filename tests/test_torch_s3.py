"""The checkpoint fetch's name-resolution rule (surya_tpu_torch/common/s3.py):
a host whose name does not exist (a ``socket.gaierror`` with ``EAI_NONAME``
anywhere in the exception's chain, whatever its message, or the glibc or
macOS message of it) is marked dead after one attempt, and the next fetch
from it raises without a request; a transient failure (``EAI_AGAIN``, a
refused connection) goes through the retry ladder.

The resolver errors are raised by the installed ``requests`` itself, with
``socket.getaddrinfo`` stubbed (nothing leaves the process), so the chain is
the one it builds: ConnectionError <- MaxRetryError <- NameResolutionError
<- gaierror in requests 2.32 with urllib3 2. ``requests.get`` is then
stubbed to raise it, and ``time.sleep`` to return at once."""

import socket
from unittest import mock

import pytest
import requests

from surya_tpu_torch.common import s3

URL = "http://weights.invalid/models/manifest.json"


def _resolver_error(errno_, message) -> Exception:
    """What requests.get raises when the resolver fails with this gaierror."""
    calls = []

    def getaddrinfo(*args, **kwargs):
        calls.append(args[0])
        raise socket.gaierror(errno_, message)

    with mock.patch("socket.getaddrinfo", getaddrinfo), pytest.raises(requests.ConnectionError) as info:
        requests.get(URL, timeout=1)
    assert calls, "the resolver stub was not reached"
    return info.value


@pytest.fixture
def fetch(monkeypatch, tmp_path):
    """_download_file of URL with requests.get raising the given error and
    time.sleep stubbed; returns (run, get calls, sleeps)."""
    monkeypatch.setattr(s3, "_DNS_DEAD", {})
    gets, sleeps = [], []
    monkeypatch.setattr(s3.time, "sleep", sleeps.append)

    def run(err, retries=3):
        def get(url, **kwargs):
            gets.append(url)
            raise err

        monkeypatch.setattr(requests, "get", get)
        return s3._download_file(URL, tmp_path / "manifest.json", retries=retries)

    return run, gets, sleeps


def _chain_types(err):
    return [type(e).__name__ for e in s3._exception_chain(err)]


def test_requests_chains_the_gaierror():
    """The installed requests keeps the gaierror in the chain, behind links
    that name no resolver error in their message alone."""
    err = _resolver_error(socket.EAI_NONAME, "getaddrinfo failed")
    chain = list(s3._exception_chain(err))
    assert isinstance(chain[0], requests.ConnectionError)
    gai = [e for e in chain if isinstance(e, socket.gaierror)]
    assert gai and gai[0].errno == socket.EAI_NONAME, _chain_types(err)


@pytest.mark.parametrize("errno_, message", [
    (socket.EAI_NONAME, "getaddrinfo failed"),  # Windows' wording
    (socket.EAI_NONAME, "Name or service not known"),  # glibc
    (8, "nodename nor servname provided, or not known"),  # macOS: its own EAI_NONAME, matched by wording
    (socket.EAI_NONAME, "no such host"),  # any other wording
], ids=["windows", "glibc", "macos", "other"])
def test_nxdomain_marks_the_host_dead(fetch, errno_, message):
    run, gets, sleeps = fetch
    err = _resolver_error(errno_, message)
    with pytest.raises(requests.ConnectionError):
        run(err)
    assert len(gets) == 1 and sleeps == []
    assert s3._dns_recently_dead(URL)
    with pytest.raises(ConnectionError, match="failed DNS resolution"):
        run(err)
    assert len(gets) == 1  # the dead host is not asked again


def test_glibc_wording_alone_marks_the_host_dead(fetch):
    """An error that carries only the glibc wording, no gaierror behind it."""
    run, gets, _ = fetch
    with pytest.raises(requests.ConnectionError):
        run(requests.ConnectionError("Failed to resolve 'weights.invalid' ([Errno -2] Name or service not known)"))
    assert len(gets) == 1 and s3._dns_recently_dead(URL)


@pytest.mark.parametrize("make_err", [
    lambda: _resolver_error(socket.EAI_AGAIN, "Temporary failure in name resolution"),
    lambda: requests.ConnectionError("Connection refused"),
], ids=["eai_again", "refused"])
@pytest.mark.parametrize("retries", [1, 3])
def test_transient_failures_are_retried(fetch, make_err, retries):
    run, gets, sleeps = fetch
    with pytest.raises(requests.ConnectionError):
        run(make_err(), retries=retries)
    assert len(gets) == retries
    assert sleeps == [2.0**a for a in range(retries - 1)]
    assert not s3._dns_recently_dead(URL)


def test_chain_walk_ends_on_a_cycle():
    """An exception whose context leads back to itself is walked once."""
    a, b = RuntimeError("a"), RuntimeError("b")
    a.__context__, b.__context__ = b, a
    assert list(s3._exception_chain(a)) == [a, b]
    assert not s3._note_dns_failure(URL, a)
