"""Web chat UI (reference: llava/serve/gradio_web_server.py:1-594); the
port's own copy of ``matryoshka_mm_tpu/serve/web_server.py``.

A self-contained aiohttp server (no gradio) with an embedded single-page
chat UI providing the same features:
model list from the controller, image upload, **video upload -> 6-frame
grid collage** (reference :22-80 ``process_video_as_image_grids``), the
**M3 scale slider 1-5 -> {1,9,36,144,576}** (reference :97-103
``scale2tokens``), temperature/top-p/max-tokens controls, and streaming
responses proxied from the worker.

One change from the JAX package's copy: the controller lookups and the
worker's stream, which block on ``requests``, run in the loop's thread
pool (the stream one chunk at a time), so one slow chat does not stall
the others.  The answers are the same.

    python -m matryoshka_mm_torch.serve.web_server --port 7860 \\
        --controller-url http://localhost:21001
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import os
from io import BytesIO

from ..conversation import SeparatorStyle, conv_templates
from ..utils.logging import (build_logger, moderation_msg, server_error_msg,
                             violates_moderation)

logger = build_logger("web_server", "web_server.log")


class ConversationLogger:
    """Per-day conversation/vote jsonl logs + content-hashed image archive
    (reference: gradio_web_server.py:106-110 get_conv_log_filename +
    :316-323 image saving by hash, :377-385 vote logging)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.image_dir = os.path.join(log_dir, "serve_images")
        os.makedirs(self.image_dir, exist_ok=True)

    def _filename(self) -> str:
        import datetime

        day = datetime.datetime.now().strftime("%Y-%m-%d")
        return os.path.join(self.log_dir, f"{day}-conv.json")

    def save_image_b64(self, b64: str) -> str:
        """Archive an uploaded image once by content hash; returns the
        hash (the log row references it instead of inlining bytes)."""
        import hashlib

        raw = base64.b64decode(b64)
        h = hashlib.md5(raw).hexdigest()
        path = os.path.join(self.image_dir, f"{h}.img")
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(raw)
        return h

    def log(self, rec_type: str, payload: dict, ip: str = "") -> None:
        import time

        row = {"tstamp": round(time.time(), 4), "type": rec_type,
               "ip": ip, **payload}
        with open(self._filename(), "a") as f:
            f.write(json.dumps(row) + "\n")

# slider position -> visual token budget (reference: gradio_web_server.py:97-103)
scale2tokens = {1: 1, 2: 9, 3: 36, 4: 144, 5: 576}

headers = {"User-Agent": "LLaVA-M3 Client"}

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>LLaVA-M3</title>
<style>
body{font-family:sans-serif;max-width:860px;margin:20px auto;padding:0 12px}
#chat{border:1px solid #ccc;border-radius:8px;min-height:300px;padding:12px;
      white-space:pre-wrap;background:#fafafa}
.user{color:#14532d;margin:8px 0}.bot{color:#1e3a8a;margin:8px 0}
.row{display:flex;gap:8px;margin-top:10px}
input[type=text]{flex:1;padding:8px}
label{font-size:13px;color:#444}
#grid-preview img{max-width:300px;border:1px solid #ddd;margin-top:6px}
</style></head><body>
<h2>LLaVA-M3 — Matryoshka visual tokens</h2>
<div>
  <label>Model <select id="model"></select></label>
  <label>Visual token scale
    <input type="range" id="scale" min="1" max="5" value="5"
           oninput="document.getElementById('sv').innerText=scale2tokens[this.value]">
    <b id="sv">576</b> tokens</label>
  <label>Temperature <input type="number" id="temp" value="0.2" step="0.1"
         style="width:56px"></label>
  <label>Max tokens <input type="number" id="maxtok" value="256"
         style="width:70px"></label>
</div>
<div class="row">
  <input type="file" id="image" accept="image/*">
  <input type="file" id="video" accept="video/*">
</div>
<div id="grid-preview"></div>
<div id="chat"></div>
<div class="row">
  <input type="text" id="msg" placeholder="Ask about the image or video…"
         onkeydown="if(event.key==='Enter')send()">
  <button onclick="send()">Send</button>
  <button onclick="clearChat()">Clear</button>
  <button onclick="vote('upvote')" title="Upvote">&#128077;</button>
  <button onclick="vote('downvote')" title="Downvote">&#128078;</button>
  <button onclick="vote('flag')" title="Flag">&#9873;</button>
</div>
<script>
const scale2tokens = {1:1, 2:9, 3:36, 4:144, 5:576};
let history = [];
fetch('/list_models', {method:'POST'}).then(r=>r.json()).then(d=>{
  const sel = document.getElementById('model');
  d.models.forEach(m=>{const o=document.createElement('option');o.text=m;sel.add(o);});
});
async function fileToB64(input){
  if(!input.files.length) return null;
  const buf = await input.files[0].arrayBuffer();
  return btoa(new Uint8Array(buf).reduce((s,b)=>s+String.fromCharCode(b), ''));
}
function clearChat(){history=[];document.getElementById('chat').innerHTML='';}
function vote(type){
  fetch('/vote', {method:'POST', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({type: type, history: history,
      model: document.getElementById('model').value})});
}
async function send(){
  const msg = document.getElementById('msg').value;
  if(!msg) return;
  document.getElementById('msg').value='';
  const chat = document.getElementById('chat');
  chat.innerHTML += '<div class=user>USER: '+msg+'</div>';
  const botDiv = document.createElement('div'); botDiv.className='bot';
  botDiv.innerText='ASSISTANT: …'; chat.appendChild(botDiv);
  const image = await fileToB64(document.getElementById('image'));
  const video = await fileToB64(document.getElementById('video'));
  const body = {
    message: msg, history: history,
    model: document.getElementById('model').value,
    scale: parseInt(document.getElementById('scale').value),
    temperature: parseFloat(document.getElementById('temp').value),
    max_new_tokens: parseInt(document.getElementById('maxtok').value),
    image_b64: image, video_b64: video,
  };
  const resp = await fetch('/chat_stream', {method:'POST',
    headers:{'Content-Type':'application/json'}, body: JSON.stringify(body)});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  while(true){
    const {done, value} = await reader.read();
    if(done) break;
    buf += dec.decode(value, {stream:true});
    const parts = buf.split('\\0');
    buf = parts.pop();
    for(const p of parts){
      if(!p) continue;
      const d = JSON.parse(p);
      botDiv.innerText = 'ASSISTANT: ' + d.text;
      if(d.grid_b64){
        document.getElementById('grid-preview').innerHTML =
          '<img src="data:image/jpeg;base64,'+d.grid_b64+'">';
      }
    }
  }
  history.push([msg, botDiv.innerText.replace('ASSISTANT: ','')]);
}
</script></body></html>"""


def _video_to_grid_b64(video_bytes: bytes) -> str:
    """video bytes -> 6-frame grid -> base64 PNG
    (reference: gradio_web_server.py:22-80)."""
    import tempfile

    from PIL import Image

    from ..igvlm.grid import create_grid_view, extract_frames

    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        f.write(video_bytes)
        path = f.name
    try:
        frames = extract_frames(path, 6)
        grid = create_grid_view(frames)
        buf = BytesIO()
        Image.fromarray(grid).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()
    finally:
        os.unlink(path)


def build_app(controller_url: str, conv_mode: str = "vicuna_v1",
              log_dir: str = None, moderate: bool = False,
              moderate_fn=None):
    """``log_dir`` enables conversation/vote jsonl logging + the hashed
    image archive; ``moderate`` turns on the content-moderation hook
    (``moderate_fn`` injectable for tests, default
    utils.logging.violates_moderation)."""
    from aiohttp import web

    import requests

    conv_log = ConversationLogger(log_dir) if log_dir else None
    check_text = moderate_fn or violates_moderation

    routes = web.RouteTableDef()

    def off_loop(fn, *args):
        """``fn(*args)`` in the loop's thread pool: it blocks on HTTP."""
        return asyncio.get_running_loop().run_in_executor(None, fn, *args)

    def list_worker_models():
        try:
            requests.post(controller_url + "/refresh_all_workers", timeout=5)
            ret = requests.post(controller_url + "/list_models", timeout=5)
            return sorted(ret.json()["models"])
        except requests.RequestException:
            return []

    def worker_address(model):
        try:
            ret = requests.post(controller_url + "/get_worker_address",
                                json={"model": model}, timeout=5)
            return ret.json()["address"]
        except requests.RequestException:
            return ""

    def worker_chunks(worker_addr, pload):
        """Yields the worker's ``\\0``-delimited chunks; raises
        ``requests.RequestException`` where the stream fails."""
        r = requests.post(worker_addr + "/worker_generate_stream",
                          headers=headers, json=pload, stream=True,
                          timeout=60)
        for chunk in r.iter_lines(decode_unicode=False, delimiter=b"\0"):
            if chunk:
                yield chunk

    @routes.get("/")
    async def index(request):
        return web.Response(text=INDEX_HTML, content_type="text/html")

    @routes.post("/vote")
    async def vote(request):
        # reference: upvote/downvote/flag buttons append a vote row to the
        # daily conv log (gradio_web_server.py:128-160,377-385)
        data = await request.json()
        vtype = data.get("type")
        if vtype not in ("upvote", "downvote", "flag"):
            return web.json_response({"ok": False,
                                      "error": f"bad vote type {vtype!r}"},
                                     status=400)
        if conv_log is not None:
            conv_log.log(vtype, {"model": data.get("model", ""),
                                 "state": data.get("history", [])},
                         ip=request.remote or "")
        return web.json_response({"ok": True, "logged": conv_log is not None})

    @routes.post("/list_models")
    async def list_models(request):
        return web.json_response({"models": await off_loop(
            list_worker_models)})

    @routes.post("/chat_stream")
    async def chat_stream(request):
        data = await request.json()
        model = data["model"]
        scale = int(data.get("scale", 5))
        grid_b64 = None

        conv = conv_templates[conv_mode].copy()
        for u, a in data.get("history", []):
            conv.append_message(conv.roles[0], u)
            conv.append_message(conv.roles[1], a)
        msg = data["message"]
        images = []
        if data.get("video_b64"):
            grid_b64 = _video_to_grid_b64(base64.b64decode(data["video_b64"]))
            images = [grid_b64]
        elif data.get("image_b64"):
            images = [data["image_b64"]]
        if images and "<image>" not in msg:
            msg = "<image>\n" + msg

        resp = web.StreamResponse()

        # moderation does a blocking HTTP POST (10s timeout) — run it on
        # a worker thread so a slow endpoint stalls only this request,
        # not every connected client on the event loop
        flagged = moderate and await off_loop(check_text, data["message"])
        if flagged:
            # flagged input never reaches the worker; the attempt is
            # logged (reference: add_text moderation path, utils.py:96-115)
            if conv_log is not None:
                conv_log.log("flagged", {"model": model,
                                         "text": data["message"]},
                             ip=request.remote or "")
            await resp.prepare(request)
            await resp.write(json.dumps(
                {"text": moderation_msg, "error_code": 1,
                 "grid_b64": grid_b64}).encode() + b"\0")
            await resp.write_eof()
            return resp

        conv.append_message(conv.roles[0], msg)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        await resp.prepare(request)

        worker_addr = await off_loop(worker_address, model)
        if not worker_addr:
            await resp.write(json.dumps(
                {"text": server_error_msg, "error_code": 2,
                 "grid_b64": grid_b64}).encode() + b"\0")
            await resp.write_eof()
            return resp

        pload = {
            "model": model,
            "prompt": prompt,
            "temperature": float(data.get("temperature", 0.2)),
            "top_p": 0.7,
            "max_new_tokens": min(int(data.get("max_new_tokens", 256)), 1536),
            "stop": (conv.sep if conv.sep_style != SeparatorStyle.TWO
                     else conv.sep2) or "</s>",
            "images": images,
            "matryoshka_vis_token_scale": f"ver=v0_numtoks={scale2tokens[scale]}",
        }
        # optional structured-output controls (serve/constrained.py):
        # honored by continuous-batching paged workers, greedy only
        if data.get("regex"):
            pload["regex"] = data["regex"]
            pload["temperature"] = 0.0
        elif data.get("json_schema"):
            pload["json_schema"] = data["json_schema"]
            pload["temperature"] = 0.0
        final_text, final_code = "", 0
        chunks = worker_chunks(worker_addr, pload)
        try:
            while True:
                chunk = await off_loop(next, chunks, None)
                if chunk is None:
                    break
                d = json.loads(chunk.decode())
                text = d["text"]
                if d.get("error_code", 0) == 0 and text.startswith(prompt):
                    text = text[len(prompt):].strip()
                final_text, final_code = text, d.get("error_code", 0)
                await resp.write(json.dumps(
                    {"text": text, "error_code": final_code,
                     "grid_b64": grid_b64}).encode() + b"\0")
                grid_b64 = None  # send once
        except requests.RequestException:
            final_text, final_code = server_error_msg, 3
            await resp.write(json.dumps(
                {"text": server_error_msg, "error_code": 3}).encode() + b"\0")
        if conv_log is not None:
            # one row per completed exchange; images archived by hash
            # (reference: http_bot finally-block logging, :356-372)
            conv_log.log("chat", {
                "model": model, "scale": scale2tokens.get(scale, scale),
                "prompt": data["message"], "response": final_text,
                "error_code": final_code,
                "images": [conv_log.save_image_b64(b) for b in images],
            }, ip=request.remote or "")
        await resp.write_eof()
        return resp

    app = web.Application(client_max_size=256 * 1024 * 1024)
    app.add_routes(routes)
    return app


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller-url", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--conv-mode", type=str, default="vicuna_v1")
    parser.add_argument("--log-dir", type=str, default="logs/web",
                        help="conversation/vote jsonl logs + image archive "
                             "('' disables)")
    parser.add_argument("--moderate", action="store_true",
                        help="content-moderation hook on user input")
    args = parser.parse_args()

    from aiohttp import web

    web.run_app(build_app(args.controller_url, args.conv_mode,
                          log_dir=args.log_dir or None,
                          moderate=args.moderate),
                host=args.host, port=args.port, print=None)


if __name__ == "__main__":
    main()
