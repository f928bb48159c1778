"""End-to-end smoke client for the serving stack (the port's own copy of
``matryoshka_mm_tpu/serve/test_message.py``).

Covers the reference capability (llava/serve/test_message.py): resolve a
worker through the controller (or hit one directly), send one templated
message, and print the ``\\0``-delimited JSON stream as it arrives.  Exits
non-zero when the stream reports an error code, so it doubles as a health
probe in scripts.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..conversation import default_conversation


def resolve_worker(controller_address: str, model_name: str) -> str:
    import requests

    requests.post(controller_address + "/refresh_all_workers")
    models = requests.post(controller_address + "/list_models").json()["models"]
    print(f"Models: {sorted(models)}")
    addr = requests.post(controller_address + "/get_worker_address",
                         json={"model": model_name}).json()["address"]
    print(f"worker_addr: {addr}")
    return addr


def iter_stream(resp):
    """Yield decoded JSON chunks from a \\0-delimited byte stream."""
    buf = b""
    for data in resp.iter_content(chunk_size=8192):
        buf += data
        while b"\0" in buf:
            part, buf = buf.split(b"\0", 1)
            if part:
                yield json.loads(part.decode())
    if buf.strip(b"\0"):
        yield json.loads(buf.decode())


def run(worker_addr: str, model_name: str, message: str,
        max_new_tokens: int, temperature: float) -> int:
    import requests

    conv = default_conversation.copy()
    conv.append_message(conv.roles[0], message)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    resp = requests.post(
        worker_addr + "/worker_generate_stream",
        headers={"User-Agent": "matryoshka-mm-torch smoke client"},
        json={"model": model_name, "prompt": prompt,
              "max_new_tokens": max_new_tokens, "temperature": temperature,
              "stop": conv.sep2 or conv.sep},
        stream=True)

    print(prompt.replace(conv.sep, "\n"), end="", flush=True)
    code = 0
    for chunk in iter_stream(resp):
        code = int(chunk.get("error_code", 0))
        print(chunk["text"].split(conv.sep)[-1], end="\r", flush=True)
    print()
    if code != 0:
        print(f"stream ended with error_code={code}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--controller-address", type=str,
                    default="http://localhost:21001")
    ap.add_argument("--worker-address", type=str)
    ap.add_argument("--model-name", type=str, default="tiny")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--message", type=str,
                    default="Tell me a story with more than 1000 words.")
    args = ap.parse_args(argv)

    addr = args.worker_address or resolve_worker(args.controller_address,
                                                 args.model_name)
    if not addr:
        print("no worker available for model", args.model_name,
              file=sys.stderr)
        return 1
    return run(addr, args.model_name, args.message, args.max_new_tokens,
               args.temperature)


if __name__ == "__main__":
    sys.exit(main())
