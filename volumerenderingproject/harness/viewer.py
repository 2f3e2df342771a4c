"""Browser viewer page for the render service — the interactive loop.

The reference is an interactive GLFW app: WASD orbits the camera, Q/E
zooms, number keys switch algorithms, M/X save/restore a camera preset,
R resets, P prints the camera, O captures a PNG (processInput
myApp.cu:1078-1241).  This framework serves instead of opening a
window, so the interactive loop lives in the browser: this page binds
the reference's exact keys and drives ``/render`` (harness/server.py),
keeping at most one request in flight and coalescing key repeats — the
HTTP analog of the recompute-only-on-camera-move gate (myApp.cu:879).

Key map (1:1 with processInput):
  W/S   pitch orbit (rotate about camera right)     myApp.cu:1088-1092
  A/D   yaw orbit (rotate about camera up)          myApp.cu:1094-1098
  Q/E   zoom along camera front                     myApp.cu:1100-1104
  1/2/3 POINT / TEST / VRC                          myApp.cu:1126-1157
  Z     toggle POINT <-> TEST                       myApp.cu:1115
  M/X   save / restore camera preset                myApp.cu:1160-1186
  R     reset camera                                myApp.cu:1224
  P     print camera state to the status line       myApp.cu:1189
  O     download the frame as PNG, reference name   myApp.cu:1203-1221
  L     toggle Phong lighting (new capability)
  B     toggle single-scattering light transport (new capability)
  C     toggle conic projection (new capability)
  V     toggle the z-buffer depth view (3.3.zbuffershader.fs analog)
"""

VIEWER_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>volumerenderingproject viewer</title>
<style>
  body { background: #202020; color: #ddd; font: 13px monospace; margin: 0; }
  #wrap { display: flex; flex-direction: column; align-items: center;
          gap: 8px; padding: 12px; }
  #frame { image-rendering: pixelated; border: 1px solid #555;
           background: #333; }
  #status { white-space: pre; color: #9c9; }
  #help { color: #888; max-width: 640px; }
  kbd { background: #333; border: 1px solid #555; border-radius: 3px;
        padding: 0 4px; }
</style>
</head>
<body>
<div id="wrap">
  <img id="frame" width="512" height="512" alt="render">
  <div id="status">connecting...</div>
  <div id="help">
    <kbd>W</kbd><kbd>A</kbd><kbd>S</kbd><kbd>D</kbd> orbit &nbsp;
    <kbd>Q</kbd>/<kbd>E</kbd> zoom &nbsp;
    <kbd>1</kbd> point <kbd>2</kbd> test <kbd>3</kbd> vrc
    <kbd>Z</kbd> point/test &nbsp; <kbd>R</kbd> reset &nbsp;
    <kbd>M</kbd>/<kbd>X</kbd> save/restore camera &nbsp;
    <kbd>P</kbd> print camera &nbsp; <kbd>O</kbd> save PNG &nbsp;
    <kbd>L</kbd> lighting &nbsp; <kbd>B</kbd> scattering &nbsp;
    <kbd>C</kbd> conic &nbsp;
    <kbd>V</kbd> depth buffer
  </div>
</div>
<script>
"use strict";
// camera state: orbit offsets from the reset preset (scene/camera.py
// applies them with the reference's rotation math, myApp.cu:1088-1112)
const ORBIT_STEP = 4.0;   // degrees per keypress
const ZOOM_STEP = 0.08;   // world units along front per keypress
const ALGOS = ["point", "vrc", "test"];
const ALGO_IDS = { point: 0, vrc: 1, test: 5 };   // utils.h:13-18
let state = { yaw: 0, pitch: 0, zoom: 0, algorithm: "vrc",
              lighting: 0, scattering: 0, conic: 0, depth: 0,
              width: 300, height: 300, spr: 300 };
let saved = null;                                  // key M preset
let inflight = false, dirty = true, lastMs = 0;

function qs() {
  return "width=" + state.width + "&height=" + state.height +
         "&spr=" + state.spr + "&algorithm=" + state.algorithm +
         "&camera=preset&orbit=" + state.yaw.toFixed(3) + "," +
         state.pitch.toFixed(3) + "," + state.zoom.toFixed(3) +
         "&lighting=" + state.lighting +
         "&scattering=" + state.scattering + "&conic=" + state.conic +
         "&depth=" + state.depth;
}

function status(extra) {
  document.getElementById("status").textContent =
    "a=" + state.algorithm +
    " yaw=" + state.yaw.toFixed(1) + " pitch=" + state.pitch.toFixed(1) +
    " zoom=" + state.zoom.toFixed(2) +
    " light=" + state.lighting + " scat=" + state.scattering +
    " conic=" + state.conic +
    " | " + lastMs.toFixed(0) + " ms" + (extra ? " | " + extra : "");
}

async function refresh() {
  if (inflight) { dirty = true; return; }   // coalesce key repeats
  inflight = true;
  do {
    dirty = false;
    const t0 = performance.now();
    try {
      const r = await fetch("/render?" + qs());
      if (!r.ok) { status("error " + r.status); break; }
      const blob = await r.blob();
      lastMs = performance.now() - t0;
      const img = document.getElementById("frame");
      const old = img.src;
      img.src = URL.createObjectURL(blob);
      if (old) URL.revokeObjectURL(old);
      status();
    } catch (e) { status("fetch failed: " + e); break; }
  } while (dirty);
  inflight = false;
}

function savePng() {
  // reference capture filename: image_{W}x{H}_a{algorithm}_spr{spr}.png
  // (myApp.cu:1209-1210)
  const a = document.createElement("a");
  a.href = "/render?" + qs();
  a.download = "image_" + state.width + "x" + state.height +
               "_a" + ALGO_IDS[state.algorithm] + "_spr" + state.spr + ".png";
  a.click();
}

document.addEventListener("keydown", (ev) => {
  const k = ev.key.toLowerCase();
  let changed = true;
  if (k === "w") state.pitch += ORBIT_STEP;        // myApp.cu:1088
  else if (k === "s") state.pitch -= ORBIT_STEP;   // myApp.cu:1090
  else if (k === "a") state.yaw += ORBIT_STEP;     // myApp.cu:1094
  else if (k === "d") state.yaw -= ORBIT_STEP;     // myApp.cu:1096
  else if (k === "q") state.zoom += ZOOM_STEP;     // myApp.cu:1100
  else if (k === "e") state.zoom -= ZOOM_STEP;     // myApp.cu:1102
  else if (k === "1") state.algorithm = "point";   // myApp.cu:1126
  else if (k === "2") state.algorithm = "test";    // myApp.cu:1136
  else if (k === "3") state.algorithm = "vrc";     // myApp.cu:1146
  else if (k === "z")                              // myApp.cu:1115
    state.algorithm = state.algorithm === "point" ? "test" : "point";
  else if (k === "r") { state.yaw = 0; state.pitch = 0; state.zoom = 0; }
  else if (k === "m") {                            // myApp.cu:1160
    saved = { yaw: state.yaw, pitch: state.pitch, zoom: state.zoom };
    status("camera saved"); changed = false;
  } else if (k === "x" && saved) {                 // myApp.cu:1175
    state.yaw = saved.yaw; state.pitch = saved.pitch; state.zoom = saved.zoom;
  } else if (k === "p") {                          // myApp.cu:1189
    status("camera: " + JSON.stringify(state)); changed = false;
  } else if (k === "o") { savePng(); changed = false; }  // myApp.cu:1203
  else if (k === "l") state.lighting = 1 - state.lighting;
  else if (k === "b") state.scattering = 1 - state.scattering;
  else if (k === "c") state.conic = 1 - state.conic;
  else if (k === "v") state.depth = 1 - state.depth;
  else changed = false;
  if (changed) refresh();
});

fetch("/health").then(r => r.json()).then(info => {
  status("volume " + info.volume.join("x"));
  refresh();
});
</script>
</body>
</html>
"""
