"""Remote-object streaming: http(s):// and s3:// (anonymous or SigV4).

The port's own copy of the JAX package's ``data/remote.py`` (standard
library only), with the same functions, environment variables and
behaviour: the zarr store (``storage/zarr.py``) reads remote stores through
``fetch_remote``, ``is_remote`` and ``aws_credentials``, and lists S3
groups through ``s3_list``.

* anonymous S3 access is plain HTTPS GET against the bucket's
  virtual-hosted endpoint;
* credentialed access is AWS Signature Version 4 (``sigv4_headers``), an
  hmac/sha256 chain over a canonical request, equal to the JAX package's
  for the same credentials and clock (``tests/test_torch_remote.py``).

Credentials come from the standard environment variables
(``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY`` / optional
``AWS_SESSION_TOKEN``; region from ``AWS_REGION`` or
``AWS_DEFAULT_REGION``, default us-east-1); ``CAE_S3_ENDPOINT`` points
s3:// URLs at another S3-compatible host.  Without credentials every
request stays anonymous.
"""

import datetime
import hashlib
import hmac
import os
import time
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET

REMOTE_SCHEMES = ("s3://", "http://", "https://")

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def aws_credentials():
    """(access_key, secret_key, session_token) from the environment, or
    None when unset — the switch between anonymous and SigV4 requests."""
    key = os.environ.get("AWS_ACCESS_KEY_ID")
    secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
    if not key or not secret:
        return None
    return key, secret, os.environ.get("AWS_SESSION_TOKEN")


def aws_region():
    return (os.environ.get("AWS_REGION")
            or os.environ.get("AWS_DEFAULT_REGION") or "us-east-1")


def _uri_encode(s, *, keep_slash=False):
    safe = "-_.~" + ("/" if keep_slash else "")
    return urllib.parse.quote(s, safe=safe)


def sigv4_headers(method, url, *, credentials, region, service="s3",
                  amz_date=None, payload_hash=_EMPTY_SHA256,
                  extra_headers=None):
    """AWS Signature Version 4 headers for ``method url``.

    Returns the headers to attach (host excluded — urllib adds it), incl.
    ``Authorization``.  The algorithm follows the AWS "signing a request"
    spec exactly (the published GET-Object / List-Objects vectors).  ``amz_date`` (YYYYMMDDTHHMMSSZ) is injectable for tests.
    """
    access_key, secret_key, token = credentials
    parts = urllib.parse.urlsplit(url)
    host = parts.netloc
    if amz_date is None:
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
    date = amz_date[:8]

    headers = {"x-amz-content-sha256": payload_hash, "x-amz-date": amz_date}
    if token:
        headers["x-amz-security-token"] = token
    if extra_headers:
        headers.update({k.lower(): v for k, v in extra_headers.items()})
    all_headers = dict(headers)
    all_headers["host"] = host

    # The URL's path must already be URI-encoded exactly once (S3 SigV4
    # prohibits double-encoding): s3_to_https encodes the key, so the
    # canonical URI is the path as it goes on the wire.
    canonical_uri = parts.path or "/"
    query = urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
    canonical_query = "&".join(
        "%s=%s" % (_uri_encode(k), _uri_encode(v))
        for k, v in sorted(query))
    signed_names = sorted(all_headers)
    canonical_headers = "".join(
        "%s:%s\n" % (name, all_headers[name].strip())
        for name in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_request = "\n".join([
        method, canonical_uri, canonical_query, canonical_headers,
        signed_headers, payload_hash])

    scope = "%s/%s/%s/aws4_request" % (date, region, service)
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    def _hmac(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    signing_key = _hmac(_hmac(_hmac(_hmac(
        ("AWS4" + secret_key).encode(), date), region), service),
        "aws4_request")
    signature = hmac.new(signing_key, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        "AWS4-HMAC-SHA256 Credential=%s/%s, SignedHeaders=%s, Signature=%s"
        % (access_key, scope, signed_headers, signature))
    return headers


def is_remote(path: str) -> bool:
    return isinstance(path, str) and path.startswith(REMOTE_SCHEMES)


def s3_to_https(url: str, endpoint: str = None) -> str:
    """s3://bucket/key -> the bucket's anonymous HTTPS endpoint.

    ``endpoint`` overrides the host (e.g. a non-AWS S3-compatible service
    or a test fixture): the object is fetched as {endpoint}/{bucket}/{key}.
    """
    bucket, _, key = url[len("s3://"):].partition("/")
    # Encode the key ONCE: S3 keys may contain spaces/'+'/'#'/non-ASCII,
    # which must be percent-encoded on the wire, and the SigV4 canonical
    # URI signs the path exactly as sent (see sigv4_headers).
    key = _uri_encode(key, keep_slash=True)
    if endpoint:
        return "%s/%s/%s" % (endpoint.rstrip("/"), bucket, key)
    return "https://%s.s3.amazonaws.com/%s" % (bucket, key)


def _s3_error_code(error):
    """The <Code> of an S3 XML error response, or None if unparseable.
    HTTPError bodies are single-read; failures here must not mask the
    original error."""
    try:
        body = error.read()
        root = ET.fromstring(body)
        el = root.find("Code")
        if el is None:  # some emulators namespace the error document
            for child in root.iter():
                if child.tag.endswith("Code"):
                    el = child
                    break
        return el.text if el is not None else None
    except Exception:  # noqa: BLE001 — diagnostic only
        return None


def fetch_remote(path: str, timeout: float = 30.0, retries: int = 3,
                 s3_endpoint: str = None,
                 missing_403_ok: bool = False) -> bytes:
    """GET a remote object with small exponential backoff.

    s3:// URLs are SigV4-signed when AWS credentials are present in the
    environment (the boto3-equivalent credentialed path), anonymous
    otherwise.  404 (and anonymous 403 — S3 reports missing keys as 403
    when the caller lacks ListBucket) raise FileNotFoundError immediately
    (no retry): absent chunks are a NORMAL zarr state (fill_value regions
    are simply not stored), so they must fail fast, not burn the backoff
    budget.

    A CREDENTIALED 403 normally raises PermissionError: with a signed
    request it usually means denied/expired auth, and treating it as a
    missing chunk would silently fill whole regions with zeros (e.g. an
    STS session token expiring mid-decompress).  BUT a principal with
    GetObject-only rights (no s3:ListBucket) receives AccessDenied 403
    for genuinely absent keys too.  ``missing_403_ok=True`` (set by the
    zarr layer once a SIGNED metadata read of the same store succeeded)
    maps that ambiguous AccessDenied to FileNotFoundError; distinguishable
    auth failures (ExpiredToken, InvalidAccessKeyId, SignatureDoesNotMatch,
    ...) still raise PermissionError by S3 error <Code>."""
    is_s3 = path.startswith("s3://")
    if is_s3 and s3_endpoint is None:
        s3_endpoint = os.environ.get("CAE_S3_ENDPOINT")
    url = s3_to_https(path, s3_endpoint) if is_s3 else path
    creds = aws_credentials() if is_s3 else None

    def add_auth(req):
        if creds is not None:
            for k, v in sigv4_headers("GET", req.full_url,
                                      credentials=creds,
                                      region=aws_region()).items():
                req.add_header(k, v)

    def missing(error):
        if error.code == 404:
            raise FileNotFoundError(path) from error
        if error.code == 403:
            if creds is None:
                raise FileNotFoundError(path) from error
            code = _s3_error_code(error)
            if missing_403_ok and code in (None, "AccessDenied"):
                raise FileNotFoundError(path) from error
            raise PermissionError(
                "signed S3 request denied (HTTP 403%s) for %s — check "
                "credentials/session-token expiry"
                % (", %s" % code if code else "", path)) from error

    return _urlopen_retry(url, timeout, retries, add_auth, missing)


def _urlopen_retry(url, timeout, retries, add_headers=None, on_http=None):
    """GET with exponential backoff; ``on_http(err)`` may raise to stop
    retrying (missing-key / auth-denied fast paths)."""
    last_error = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(url)
            if add_headers is not None:
                add_headers(req)
            with urllib.request.urlopen(req, timeout=timeout) as response:
                return response.read()
        except urllib.error.HTTPError as error:
            if on_http is not None:
                on_http(error)
            last_error = error
            if attempt + 1 < retries:
                time.sleep(min(2 ** attempt, 5.0))
        except Exception as error:  # urllib raises several unrelated types
            last_error = error
            if attempt + 1 < retries:
                time.sleep(min(2 ** attempt, 5.0))
    raise RuntimeError("failed to fetch %s after %d attempts: %s"
                       % (url, retries, last_error)) from last_error


def s3_list(url: str, delimiter: str = "/", s3_endpoint: str = None):
    """List an s3:// prefix via ListObjectsV2 (paginated).

    Returns ``(keys, prefixes)``: object keys (with their sizes as a dict)
    directly under the prefix and, with the default delimiter, the common
    sub-prefixes — enough for zarr group listing and nbytes_stored on
    remote stores (the boto3 ``list_objects_v2`` equivalent).  Signed when credentials
    are present, anonymous otherwise; each page retries with the same
    backoff policy as fetch_remote.
    """
    bucket, _, prefix = url[len("s3://"):].partition("/")
    if prefix and not prefix.endswith("/"):
        prefix += "/"
    if s3_endpoint is None:
        s3_endpoint = os.environ.get("CAE_S3_ENDPOINT")
    base = (s3_endpoint.rstrip("/") + "/" + bucket) if s3_endpoint \
        else "https://%s.s3.amazonaws.com" % bucket
    creds = aws_credentials()

    def add_auth(req):
        if creds is not None:
            for k, v in sigv4_headers("GET", req.full_url,
                                      credentials=creds,
                                      region=aws_region()).items():
                req.add_header(k, v)

    def fail_fast(error):
        # ListObjectsV2 4xx is never transient: 404 = NoSuchBucket (an
        # absent PREFIX lists as empty, not 404), 403 = the principal
        # lacks s3:ListBucket.  Retrying masks the condition behind ~3 s
        # of backoff and a generic RuntimeError; classify immediately
        # like fetch_remote does.
        if error.code == 404:
            raise FileNotFoundError("s3://%s/%s (NoSuchBucket)"
                                    % (bucket, prefix)) from error
        if error.code == 403:
            code = _s3_error_code(error)
            raise PermissionError(
                "S3 listing denied (HTTP 403%s) for s3://%s/%s — the "
                "principal needs s3:ListBucket on the bucket (GetObject "
                "alone cannot list); or check credential expiry"
                % (", %s" % code if code else "", bucket, prefix)
            ) from error

    keys, prefixes = {}, []
    token = None
    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    while True:
        query = [("list-type", "2"), ("prefix", prefix)]
        if delimiter:
            query.append(("delimiter", delimiter))
        if token:
            query.append(("continuation-token", token))
        # quote (not quote_plus): SigV4 canonicalizes spaces as %20, so
        # the wire bytes must match what parse_qsl+re-encode signs
        qs = urllib.parse.urlencode(sorted(query),
                                    quote_via=urllib.parse.quote)
        list_url = "%s/?%s" % (base, qs)
        root = ET.fromstring(
            _urlopen_retry(list_url, 30.0, 3, add_auth, fail_fast))
        for el in root.findall(ns + "Contents"):
            keys[el.find(ns + "Key").text] = int(el.find(ns + "Size").text)
        for el in root.findall(ns + "CommonPrefixes"):
            prefixes.append(el.find(ns + "Prefix").text)
        token_el = root.find(ns + "NextContinuationToken")
        token = token_el.text if token_el is not None else None
        if not token:
            return keys, prefixes
