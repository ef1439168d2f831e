/* Drawing client for the neural brushstroke engine.
 *
 * Fresh implementation of the two-canvas drawing architecture the reference
 * UI describes (forger/ui/README.md): strokeCanvas holds the raw user
 * geometry (what the model conditions on), paintCanvas holds the GAN
 * renders of the ACTIVE layer, bakedPaintCanvas holds baked (committed)
 * layers below it.  While drawing, dirty patch windows of the model's patch
 * width are sent over a binary websocket; responses are composited back.
 * Wire protocol: see brushstroke_engine_torch/ui/protocol.py.
 *
 * Input: unified pointer events cover mouse, touch, and stylus (with
 * pressure-scaled width and optional palm rejection) -- the modern
 * equivalent of the reference's touches.js.  Extra features: layers with
 * bake ("new layer"), per-stroke auto-layers, a debug-sheet panel fed by
 * rtype==1 responses, brush interpolation (shift-click a second brush +
 * blend slider), and a demo mode (?demo) that locks simple defaults.
 */
(function () {
  "use strict";

  const $ = function (id) { return document.getElementById(id); };
  const baked = $("bakedPaintCanvas");
  const paint = $("paintCanvas");
  const stroke = $("strokeCanvas");
  const bctx = baked.getContext("2d");
  const pctx = paint.getContext("2d");
  const sctx = stroke.getContext("2d");
  const status = $("status");

  let patchWidth = 256;
  let cropMargin = 10;
  let drawing = false;
  let brushRadius = 8;
  let dirty = null; // {x0,y0,x1,y1}
  let pending = 0;

  const ws = new WebSocket(
    (location.protocol === "https:" ? "wss://" : "ws://") + location.host +
    "/websocket/");
  ws.binaryType = "arraybuffer";

  ws.onopen = function () {
    status.textContent = "connected";
    // Sync the initial control state: the server's defaults are not
    // guaranteed to match the checkboxes' initial values.
    sendJSON({ type: "set_option", option: "positions",
               value: $("usePositions").checked });
    sendJSON({ type: "set_option", option: "uvs_mapping",
               value: $("uvsMapping").checked });
    sendJSON({ type: "set_render_mode", mode: $("renderMode").value });
    sendNewCanvas();
  };
  ws.onclose = function () { status.textContent = "disconnected"; };

  ws.onmessage = function (ev) {
    if (typeof ev.data === "string") {
      const msg = JSON.parse(ev.data);
      if (msg.type === "modelinfo") {
        patchWidth = msg.data.patch_width;
        status.textContent = "ready (patch " + patchWidth + ")";
      } else if (msg.type === "brushinfo") {
        status.textContent = "brush " + msg.data.style_id +
          (msg.data.library_id ? " / " + msg.data.library_id : "");
      }
      return;
    }
    // Binary response: [type i32][w,h,x,y i32][RGBA].
    const dv = new DataView(ev.data);
    const rtype = dv.getInt32(0, true);
    const w = dv.getInt32(4, true);
    const h = dv.getInt32(8, true);
    const x = dv.getInt32(12, true);
    const y = dv.getInt32(16, true);
    const pixels = new Uint8ClampedArray(ev.data, 20, w * h * 4);
    const img = new ImageData(pixels, w, h);
    const off = new OffscreenCanvas(w, h);
    off.getContext("2d").putImageData(img, 0, 0);
    if (rtype === 1) {
      // Debug sheet: show in the sidebar panel (scaled to fit).
      const dbg = $("debugCanvas");
      const dctx = dbg.getContext("2d");
      dctx.clearRect(0, 0, dbg.width, dbg.height);
      dctx.drawImage(off, 0, 0, dbg.width,
                     Math.round(dbg.width * h / w));
      return;
    }
    pctx.clearRect(x, y, w, h);
    pctx.drawImage(off, x, y);
    pending--;
  };

  function sendJSON(obj) { ws.send(JSON.stringify(obj)); }

  function sendNewCanvas() {
    sendJSON({
      type: "new_canvas", rows: paint.height, cols: paint.width,
      feature_blending: parseInt($("featureBlending").value, 10)
    });
  }

  function hexToRgb(hex) {
    return [parseInt(hex.slice(1, 3), 16), parseInt(hex.slice(3, 5), 16),
            parseInt(hex.slice(5, 7), 16)];
  }

  function buildColorList() {
    if (!$("useColors").checked) return [];
    const c0 = hexToRgb($("color0").value);
    const c1 = hexToRgb($("color1").value);
    return [[0].concat(c0), [1].concat(c1)];
  }

  function sendPatch(px, py, debug) {
    // Clamp to canvas bounds.
    px = Math.max(0, Math.min(px, stroke.width - patchWidth));
    py = Math.max(0, Math.min(py, stroke.height - patchWidth));
    const data = sctx.getImageData(px, py, patchWidth, patchWidth);
    const colors = buildColorList();
    const head = new Uint8Array(3 + 4 * colors.length);
    head[0] = debug ? 1 : 0; head[1] = colors.length; head[2] = 0;
    colors.forEach(function (c, i) {
      head.set(c, 3 + 4 * i);
    });
    const meta = new Int32Array(
      [patchWidth, patchWidth, px, py, cropMargin]);
    const buf = new Uint8Array(
      head.length + meta.byteLength + data.data.length);
    buf.set(head, 0);
    buf.set(new Uint8Array(meta.buffer), head.length);
    buf.set(data.data, head.length + meta.byteLength);
    pending++;
    ws.send(buf.buffer);
  }

  function flushDirty() {
    if (!dirty) return;
    const debug = $("showDebug").checked;
    const stride = patchWidth - 2 * cropMargin;
    for (let y = dirty.y0 - cropMargin; y < dirty.y1; y += stride) {
      for (let x = dirty.x0 - cropMargin; x < dirty.x1; x += stride) {
        sendPatch(x, y, debug);
      }
    }
    dirty = null;
  }

  function markDirty(x, y) {
    const r = brushRadius + 2;
    if (!dirty) dirty = { x0: x - r, y0: y - r, x1: x + r, y1: y + r };
    dirty.x0 = Math.min(dirty.x0, x - r);
    dirty.y0 = Math.min(dirty.y0, y - r);
    dirty.x1 = Math.max(dirty.x1, x + r);
    dirty.y1 = Math.max(dirty.y1, y + r);
    // Flush early if the dirty window exceeds half a patch.
    if (dirty.x1 - dirty.x0 > patchWidth / 2 ||
        dirty.y1 - dirty.y0 > patchWidth / 2) {
      flushDirty();
    }
  }

  function canvasPos(ev) {
    const rect = stroke.getBoundingClientRect();
    return [ev.clientX - rect.left, ev.clientY - rect.top];
  }

  // ---- layers: bake the active layer down and start a fresh one ----
  // (reference main_controller.js newLayer/bakeLayers :150-160)
  function bakeLayer() {
    bctx.drawImage(paint, 0, 0);
    pctx.clearRect(0, 0, paint.width, paint.height);
    sctx.clearRect(0, 0, stroke.width, stroke.height);
    sendNewCanvas();  // fresh server-side geometry/feature canvas
  }

  // ---- undo/redo: snapshot all three canvases per completed stroke ----
  const undoStack = [];
  const redoStack = [];
  const UNDO_LIMIT = 24;

  function snapshot() {
    return {
      s: sctx.getImageData(0, 0, stroke.width, stroke.height),
      p: pctx.getImageData(0, 0, paint.width, paint.height),
      b: bctx.getImageData(0, 0, baked.width, baked.height)
    };
  }

  function restore(snap) {
    sctx.putImageData(snap.s, 0, 0);
    pctx.putImageData(snap.p, 0, 0);
    bctx.putImageData(snap.b, 0, 0);
    // Server-side geometry canvas must match the stroke canvas again.
    sendNewCanvas();
    resendAll();
  }

  function resendAll() {
    // Re-render the whole (restored) geometry canvas patch by patch.
    const stride = patchWidth - 2 * cropMargin;
    for (let y = 0; y < stroke.height; y += stride) {
      for (let x = 0; x < stroke.width; x += stride) {
        sendPatch(x, y, false);
      }
    }
  }

  function pushUndo() {
    undoStack.push(snapshot());
    if (undoStack.length > UNDO_LIMIT) undoStack.shift();
    redoStack.length = 0;
  }

  function undo() {
    if (!undoStack.length) return;
    redoStack.push(snapshot());
    restore(undoStack.pop());
  }

  function redo() {
    if (!redoStack.length) return;
    undoStack.push(snapshot());
    restore(redoStack.pop());
  }

  // ---- pointer input: mouse, touch, stylus (pressure + palm rejection) --
  let last = null;
  let activePointer = null;

  function acceptPointer(ev) {
    if ($("stylusOnly").checked && ev.pointerType === "touch") return false;
    return activePointer === null || ev.pointerId === activePointer;
  }

  function strokeWidth(ev) {
    const base = parseInt($("brushSize").value, 10);
    if ($("pressureSize").checked && ev.pointerType !== "mouse" &&
        ev.pressure > 0) {
      return Math.max(1, base * ev.pressure * 1.5);
    }
    return base;
  }

  stroke.addEventListener("pointerdown", function (ev) {
    if (!acceptPointer(ev)) return;
    activePointer = ev.pointerId;
    try { stroke.setPointerCapture(ev.pointerId); } catch (e) {}
    ev.preventDefault();
    drawing = true;
    pushUndo();
    last = canvasPos(ev);
    brushRadius = strokeWidth(ev);
    const erasing = $("eraser").checked;
    sctx.lineCap = "round";
    sctx.lineJoin = "round";
    sctx.globalCompositeOperation =
      erasing ? "destination-out" : "source-over";
    sctx.strokeStyle = "rgba(0,0,0,1)";
    sctx.lineWidth = brushRadius * 2;
    markDirty(last[0], last[1]);
  });

  stroke.addEventListener("pointermove", function (ev) {
    if (!drawing || ev.pointerId !== activePointer) return;
    ev.preventDefault();
    // Coalesced events give full stylus sampling rate where available.
    const events = ev.getCoalescedEvents ? ev.getCoalescedEvents() : [ev];
    for (const e of events) {
      const pos = canvasPos(e);
      brushRadius = strokeWidth(e);
      sctx.lineWidth = brushRadius * 2;
      sctx.beginPath();
      sctx.moveTo(last[0], last[1]);
      sctx.lineTo(pos[0], pos[1]);
      sctx.stroke();
      markDirty(pos[0], pos[1]);
      last = pos;
    }
  });

  function endStroke(ev) {
    if (!drawing || (ev && ev.pointerId !== activePointer)) return;
    drawing = false;
    activePointer = null;
    flushDirty();
    if ($("autoNewLayer").checked) {
      // Bake after the server responses land (pending drains).
      const waitBake = function () {
        if (pending > 0) { setTimeout(waitBake, 50); return; }
        bakeLayer();
      };
      setTimeout(waitBake, 50);
    }
  }
  window.addEventListener("pointerup", endStroke);
  window.addEventListener("pointercancel", endStroke);

  // ---- controls ----
  $("newBrush").onclick = function () { sendJSON({ type: "set_brush" }); };
  $("saveBrush").onclick = function () { sendJSON({ type: "save_brush" }); };
  $("clearCanvas").onclick = function () {
    pushUndo();
    sctx.clearRect(0, 0, stroke.width, stroke.height);
    pctx.clearRect(0, 0, paint.width, paint.height);
    bctx.clearRect(0, 0, baked.width, baked.height);
    sendNewCanvas();
  };
  $("newLayer").onclick = function () { pushUndo(); bakeLayer(); };
  // Download the composed painting (baked layers + active layer) as PNG,
  // or the raw user stroke geometry (reference downloadAll/downloadStroke,
  // main_controller.js).
  function downloadCanvas(draw, name) {
    const out = document.createElement("canvas");
    out.width = paint.width;
    out.height = paint.height;
    draw(out.getContext("2d"));
    const a = document.createElement("a");
    a.href = out.toDataURL("image/png");
    a.download = name;
    a.click();
  }
  $("downloadPainting").onclick = function () {
    downloadCanvas(function (ctx) {
      ctx.fillStyle = "#ffffff";
      ctx.fillRect(0, 0, paint.width, paint.height);
      ctx.drawImage(baked, 0, 0);
      ctx.drawImage(paint, 0, 0);
    }, "painting.png");
  };
  $("downloadStroke").onclick = function () {
    downloadCanvas(function (ctx) {
      ctx.drawImage(stroke, 0, 0);
    }, "stroke.png");
  };
  $("renderMode").onchange = function (ev) {
    sendJSON({ type: "set_render_mode", mode: ev.target.value });
  };
  $("uvsMapping").onchange = function (ev) {
    sendJSON({ type: "set_option", option: "uvs_mapping",
               value: ev.target.checked });
  };
  $("usePositions").onchange = function (ev) {
    sendJSON({ type: "set_option", option: "positions",
               value: ev.target.checked });
  };
  $("featureBlending").onchange = sendNewCanvas;
  $("hideStroke").onchange = function (ev) {
    stroke.style.opacity = ev.target.checked ? "0" : "1";
  };
  $("showDebug").onchange = function (ev) {
    $("debugCanvas").style.display = ev.target.checked ? "block" : "none";
  };
  $("undo").onclick = undo;
  $("redo").onclick = redo;
  window.addEventListener("keydown", function (ev) {
    if (!(ev.ctrlKey || ev.metaKey)) return;
    if (ev.key === "z") { ev.preventDefault(); undo(); }
    if (ev.key === "y") { ev.preventDefault(); redo(); }
  });

  // ---- brush selection + interpolation (shift-click second brush) ----
  let brushA = null;  // {library, style}
  let brushB = null;

  function sendBrushSelection() {
    if (!brushA) return;
    const msg = { type: "set_brush", library_id: brushA.library,
                  style_id: brushA.style };
    if (brushB && brushB.library === brushA.library) {
      msg.style_id2 = brushB.style;
      msg.alpha = 1.0 - parseInt($("interpAlpha").value, 10) / 100.0;
      $("interpInfo").textContent =
        "blend " + brushA.style + " / " + brushB.style;
    } else {
      $("interpInfo").textContent = "";
    }
    sendJSON(msg);
  }

  document.querySelectorAll(".brush-grid img").forEach(function (img) {
    img.onclick = function (ev) {
      const pick = { library: img.dataset.library,
                     style: img.dataset.style };
      if (ev.shiftKey && brushA) {
        document.querySelectorAll(".brush-grid img.selected2").forEach(
          function (el) { el.classList.remove("selected2"); });
        img.classList.add("selected2");
        brushB = pick;
      } else {
        document.querySelectorAll(
          ".brush-grid img.selected, .brush-grid img.selected2").forEach(
          function (el) {
            el.classList.remove("selected");
            el.classList.remove("selected2");
          });
        img.classList.add("selected");
        brushA = pick;
        brushB = null;
      }
      sendBrushSelection();
    };
  });
  $("interpAlpha").onchange = sendBrushSelection;

  // ---- demo mode: simple locked-down defaults (reference
  // main_controller.js setDemoMode :98-111).  UI state applies now; the
  // matching server options go out in ws.onopen's initial sync, which
  // reads these controls.
  if (document.body.dataset.demo === "1") {
    document.body.classList.add("demo");
    $("renderMode").value = "clear";
    $("featureBlending").value = "2";
    $("uvsMapping").checked = true;
    $("autoNewLayer").checked = true;
    $("hideStroke").checked = true;
    stroke.style.opacity = "0";
  }
})();
