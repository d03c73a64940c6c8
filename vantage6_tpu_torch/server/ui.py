"""Built-in web UI.

Parity: the reference ships an Angular SPA (SURVEY.md §2 item 27) for
administration and task management. Here a dependency-free single-page app
(vanilla JS + the server's own REST API) is served by the control plane
itself at ``/`` — login/MFA, collaborations, node liveness, task submission
(freeform + store-metadata wizard), a full run-log/result viewer with
per-run timing, studies/sessions, admin CRUD (organizations, users, roles)
with rule-level role management and user role assignment, and the COMPLETE
store workflow in the browser: browse by status, submit an algorithm,
start a review, approve/reject with comment (same-origin proxy,
resources.py `_store_forward`). Deliberately buildless: one HTML document,
no bundler, no CDN (zero-egress deployments), trivially auditable.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from vantage6_tpu_torch.server.web import Request, Response

if TYPE_CHECKING:  # pragma: no cover
    from vantage6_tpu_torch.server.app import ServerApp

PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>vantage6-tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root { --bg:#10141a; --panel:#1a212b; --text:#e6e9ee; --dim:#8b97a6;
        --accent:#4fa3ff; --ok:#3fb97c; --bad:#e0635c; --warn:#d9a441; }
* { box-sizing:border-box; }
body { margin:0; background:var(--bg); color:var(--text);
       font:14px/1.5 system-ui, sans-serif; }
header { display:flex; align-items:center; gap:1rem; padding:.7rem 1.2rem;
         background:var(--panel); border-bottom:1px solid #2a3442; }
header h1 { font-size:1rem; margin:0; letter-spacing:.04em; }
header .who { margin-left:auto; color:var(--dim); }
main { max-width:1100px; margin:1.2rem auto; padding:0 1rem; }
.panel { background:var(--panel); border:1px solid #2a3442; border-radius:8px;
         padding:1rem 1.2rem; margin-bottom:1rem; }
h2 { font-size:.85rem; text-transform:uppercase; letter-spacing:.08em;
     color:var(--dim); margin:.2rem 0 .8rem; }
table { width:100%; border-collapse:collapse; }
th, td { text-align:left; padding:.35rem .5rem; border-bottom:1px solid #242e3b; }
th { color:var(--dim); font-weight:500; }
tr:hover td { background:#202a36; }
input, select, textarea, button {
  background:#0d1117; color:var(--text); border:1px solid #2a3442;
  border-radius:6px; padding:.45rem .6rem; font:inherit; }
button { background:var(--accent); color:#081018; border:none; cursor:pointer;
         font-weight:600; }
button.ghost { background:transparent; color:var(--accent);
               border:1px solid var(--accent); }
.badge { padding:.1rem .5rem; border-radius:10px; font-size:.75rem; }
.badge.online, .badge.completed { background:#15392a; color:var(--ok); }
.badge.offline, .badge.crashed, .badge.failed { background:#3d1f1d; color:var(--bad); }
.badge.pending, .badge.active { background:#3a2f16; color:var(--warn); }
.row { display:flex; gap:.6rem; flex-wrap:wrap; align-items:center; }
#login { max-width:360px; margin:14vh auto; }
.err { color:var(--bad); min-height:1.2em; }
pre { background:#0d1117; padding:.6rem; border-radius:6px; overflow:auto; }
a { color:var(--accent); cursor:pointer; }
.hidden { display:none; }
</style>
</head>
<body>
<header>
  <h1>vantage6-tpu</h1>
  <span id="version" class="who"></span>
  <span id="whoami" class="who"></span>
  <button id="logout" class="ghost hidden">log out</button>
</header>
<main>
  <div id="login" class="panel">
    <h2>Sign in</h2>
    <div class="row" style="flex-direction:column; align-items:stretch">
      <input id="username" placeholder="username" autocomplete="username">
      <input id="password" type="password" placeholder="password"
             autocomplete="current-password">
      <input id="mfa" placeholder="MFA code (if enabled)">
      <button id="signin">Sign in</button>
      <div id="loginerr" class="err"></div>
    </div>
  </div>

  <div id="appview" class="hidden">
    <nav class="row" style="margin-bottom:1rem">
      <button class="tabbtn" data-tab="overview">Overview</button>
      <button class="tabbtn ghost" data-tab="admin">Admin</button>
      <button class="tabbtn ghost" data-tab="store">Store</button>
    </nav>

    <div id="tab_overview">
    <div class="panel">
      <h2>Nodes</h2>
      <table id="nodes"><thead><tr>
        <th>name</th><th>organization</th><th>collaboration</th><th>status</th>
      </tr></thead><tbody></tbody></table>
    </div>
    <div class="panel">
      <h2>Collaborations</h2>
      <table id="collabs"><thead><tr>
        <th>id</th><th>name</th><th>encrypted</th><th>organizations</th>
      </tr></thead><tbody></tbody></table>
    </div>
    <div class="panel">
      <h2>New task</h2>
      <div class="row">
        <select id="t_collab"></select>
        <select id="t_study" title="target a study subset">
          <option value="">whole collaboration</option></select>
        <select id="t_algo" title="pick an approved store algorithm to get
a guided form, or stay freeform">
          <option value="">freeform algorithm</option></select>
      </div>
      <div class="row" id="t_freeform" style="margin-top:.5rem">
        <input id="t_image" placeholder="algorithm image" size="22">
        <input id="t_method" placeholder="method" size="16">
        <input id="t_kwargs" placeholder='kwargs JSON, e.g. {"column":"age"}'
               size="30">
      </div>
      <div id="t_wizard" class="hidden" style="margin-top:.5rem">
        <div class="row">
          <select id="w_function"></select>
          <span id="w_fndesc" class="who"></span>
        </div>
        <div id="w_args" class="row" style="margin-top:.4rem"></div>
      </div>
      <div class="row" style="margin-top:.5rem">
        <select id="t_session"><option value="">no session</option></select>
        <input id="t_store_as" size="18"
               placeholder="store as (session dataframe)">
        <button id="t_create">Create</button>
      </div>
      <div id="taskerr" class="err"></div>
    </div>
    <div class="panel">
      <h2>Studies</h2>
      <table id="studies"><thead><tr>
        <th>id</th><th>name</th><th>collaboration</th><th>organizations</th>
      </tr></thead><tbody></tbody></table>
      <div class="row" style="margin-top:.6rem">
        <input id="st_name" placeholder="study name" size="18">
        <select id="st_collab"></select>
        <select id="st_orgs" multiple size="3"
                title="member organizations (ctrl-click for several)"></select>
        <button id="st_create">Create study</button>
      </div>
      <div id="studyerr" class="err"></div>
    </div>
    <div class="panel">
      <h2>Sessions</h2>
      <table id="sessions"><thead><tr>
        <th>id</th><th>name</th><th>collaboration</th><th>scope</th>
        <th>dataframes</th><th></th>
      </tr></thead><tbody></tbody></table>
      <div class="row" style="margin-top:.6rem">
        <input id="se_name" placeholder="session name" size="18">
        <select id="se_collab"></select>
        <select id="se_scope">
          <option value="collaboration">collaboration</option>
          <option value="own">own</option>
        </select>
        <button id="se_create">Create session</button>
      </div>
      <div id="sesserr" class="err"></div>
    </div>
    <div class="panel">
      <h2>Tasks</h2>
      <table id="tasks"><thead><tr>
        <th>id</th><th>name</th><th>image</th><th>method</th><th>status</th>
        <th></th>
      </tr></thead><tbody></tbody></table>
    </div>
    <div class="panel hidden" id="detailpanel">
      <h2>Task <span id="d_id"></span></h2>
      <table id="runs"><thead><tr>
        <th>run</th><th>organization</th><th>node</th><th>status</th>
        <th>timing</th><th></th>
      </tr></thead><tbody></tbody></table>
    </div>
    <div class="panel hidden" id="runlogpanel">
      <h2>Run <span id="rl_id"></span> <span id="rl_meta" class="who"></span></h2>
      <h2>log</h2><pre id="rl_log"></pre>
      <h2>result (serialized)</h2><pre id="rl_result"></pre>
    </div>
    </div><!-- /tab_overview -->

    <div id="tab_admin" class="hidden">
    <div class="panel">
      <h2>Organizations</h2>
      <table id="a_orgs"><thead><tr>
        <th>id</th><th>name</th><th>country</th><th>public key</th>
      </tr></thead><tbody></tbody></table>
      <div class="row" style="margin-top:.6rem">
        <input id="o_name" placeholder="new organization name" size="24">
        <input id="o_country" placeholder="country" size="12">
        <button id="o_create">Create organization</button>
      </div>
      <div id="orgerr" class="err"></div>
    </div>
    <div class="panel">
      <h2>Users</h2>
      <table id="a_users"><thead><tr>
        <th>id</th><th>username</th><th>email</th><th>organization</th>
        <th>roles</th><th></th>
      </tr></thead><tbody></tbody></table>
      <div class="row" style="margin-top:.6rem">
        <input id="u_name" placeholder="username" size="14">
        <input id="u_pass" type="password" placeholder="password" size="14">
        <input id="u_email" placeholder="email" size="18">
        <select id="u_org"></select>
        <select id="u_roles" multiple size="3"
                title="roles (ctrl-click for several)"></select>
        <button id="u_create">Create user</button>
      </div>
      <div id="usererr" class="err"></div>
    </div>
    <div class="panel">
      <h2>Roles</h2>
      <table id="a_roles"><thead><tr>
        <th>id</th><th>name</th><th>organization</th><th>rules</th><th></th>
      </tr></thead><tbody></tbody></table>
      <div class="row" style="margin-top:.6rem">
        <input id="r_name" placeholder="role name" size="16">
        <select id="r_org"><option value="">global</option></select>
        <select id="r_rules" multiple size="4"
                title="rules (ctrl-click for several)"></select>
        <button id="r_create">Create role</button>
      </div>
      <div id="roleerr" class="err"></div>
    </div>
    <div class="panel hidden" id="roledetail">
      <h2>Role <span id="rd_name"></span></h2>
      <table id="rd_rules"><thead><tr>
        <th>rule</th><th>scope</th><th>operation</th>
      </tr></thead><tbody></tbody></table>
      <div class="row" style="margin-top:.6rem">
        <select id="rd_edit_rules" multiple size="5"
                title="replace this role's rules (ctrl-click)"></select>
        <button id="rd_save">Save rules</button>
        <button id="rd_delete" class="ghost">Delete role</button>
        <span id="rd_msg" class="who"></span>
      </div>
      <div id="rd_err" class="err"></div>
    </div>
    <div class="panel hidden" id="userdetail">
      <h2>User <span id="ud_name"></span></h2>
      <div class="row">
        <select id="ud_roles" multiple size="4"
                title="replace this user's roles (ctrl-click)"></select>
        <button id="ud_save">Save roles</button>
        <span id="ud_msg" class="who"></span>
      </div>
      <div id="ud_err" class="err"></div>
    </div>
    <div class="panel">
      <h2>My account</h2>
      <div class="row">
        <input id="pw_current" type="password" placeholder="current password"
               autocomplete="current-password" size="18">
        <input id="pw_new" type="password" placeholder="new password (min 8)"
               autocomplete="new-password" size="18">
        <button id="pw_change">Change password</button>
        <span id="pw_msg" class="who"></span>
      </div>
      <div id="pwerr" class="err"></div>
    </div>
    </div><!-- /tab_admin -->

    <div id="tab_store" class="hidden">
    <div class="panel">
      <h2>Algorithm store <span id="s_url" class="who"></span></h2>
      <div class="row" style="margin-bottom:.5rem">
        <select id="s_status" title="which submissions to list">
          <option value="">approved (public)</option>
          <option value="submitted">submitted</option>
          <option value="under review">under review</option>
          <option value="rejected">rejected</option>
        </select>
      </div>
      <table id="s_algos"><thead><tr>
        <th>id</th><th>name</th><th>image</th><th>status</th><th>functions</th>
      </tr></thead><tbody></tbody></table>
      <div id="storeerr" class="err"></div>
    </div>
    <div class="panel">
      <h2>Submit algorithm</h2>
      <div class="row">
        <input id="sa_name" placeholder="name" size="18">
        <input id="sa_image" size="32"
               placeholder="image ref, e.g. registry/algos/avg:1.0">
      </div>
      <div class="row" style="margin-top:.4rem">
        <input id="sa_desc" placeholder="description" size="52">
      </div>
      <div class="row" style="margin-top:.4rem">
        <textarea id="sa_functions" rows="4" cols="64" placeholder='functions JSON, e.g. [{"name":"partial_average","type":"federated","arguments":[{"name":"column","type":"column"}]}]'></textarea>
      </div>
      <div class="row" style="margin-top:.4rem">
        <button id="sa_submit">Submit for review</button>
        <span id="sa_msg" class="who"></span>
      </div>
      <div id="saerr" class="err"></div>
    </div>
    <div class="panel hidden" id="s_detailpanel">
      <h2>Algorithm <span id="s_d_name"></span></h2>
      <div id="s_d_desc" class="who"></div>
      <table id="s_d_functions"><thead><tr>
        <th>function</th><th>type</th><th>arguments</th><th>databases</th>
      </tr></thead><tbody></tbody></table>
      <h2 style="margin-top:.8rem">Reviews</h2>
      <table id="s_d_reviews"><thead><tr>
        <th>id</th><th>reviewer</th><th>status</th><th>comment</th><th></th>
      </tr></thead><tbody></tbody></table>
      <div class="row" style="margin-top:.5rem">
        <button id="s_d_startreview" class="ghost">Start review (assign me)</button>
        <input id="s_d_comment" placeholder="review comment" size="30">
        <span id="s_d_msg" class="who"></span>
      </div>
      <div id="s_d_err" class="err"></div>
    </div>
    </div><!-- /tab_store -->
  </div>
</main>
<script>
"use strict";
let token = sessionStorage.getItem("v6t_token") || null;
const $ = (id) => document.getElementById(id);

// every server-sourced string goes through esc() before innerHTML — task
// names/images/logs are collaborator-controlled input (stored-XSS vector)
function esc(v) {
  return String(v ?? "").replace(/[&<>"']/g, (c) => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  })[c]);
}

async function api(method, path, body) {
  const opts = { method, headers: {} };
  if (token) opts.headers["Authorization"] = "Bearer " + token;
  if (body !== undefined) {
    opts.headers["Content-Type"] = "application/json";
    opts.body = JSON.stringify(body);
  }
  const resp = await fetch("/api/" + path, opts);
  const data = resp.status === 204 ? {} : await resp.json();
  if (!resp.ok) throw new Error(data.msg || resp.statusText);
  return data;
}

function badge(status) {
  const cls = esc(String(status).split(" ")[0]);
  return `<span class="badge ${cls}">${esc(status)}</span>`;
}

function fill(tableId, rows, renderer) {
  $(tableId).querySelector("tbody").innerHTML = rows.map(renderer).join("");
}

let collabCache = [];

function keepSelection(sel, html) {
  // refresh() reruns every 3 s: rebuilding <option>s must not clobber what
  // the user picked mid-form (including ctrl-click MULTI-selections)
  const prev = new Set(
    [...sel.selectedOptions].map((o) => o.value));
  sel.innerHTML = html;
  let any = false;
  for (const o of sel.options) {
    if (prev.has(o.value)) { o.selected = true; any = true; }
    else if (sel.multiple) o.selected = false;
  }
  if (!any && !sel.multiple && sel.options.length) sel.selectedIndex = 0;
}

async function refresh() {
  const [nodes, collabs, tasks, studies, sessions] = await Promise.all([
    api("GET", "node"), api("GET", "collaboration"), api("GET", "task"),
    api("GET", "study").catch(() => ({ data: [] })),
    api("GET", "session").catch(() => ({ data: [] })),
  ]);
  collabCache = collabs.data;
  fill("nodes", nodes.data, (n) =>
    `<tr><td>${esc(n.name)}</td><td>${esc(n.organization.id)}</td>` +
    `<td>${esc(n.collaboration.id)}</td><td>${badge(n.status)}</td></tr>`);
  fill("collabs", collabs.data, (c) =>
    `<tr><td>${esc(c.id)}</td><td>${esc(c.name)}</td><td>${c.encrypted}</td>` +
    `<td>${esc(c.organizations.join(", "))}</td></tr>`);
  // encrypted collaborations need client-side key material the browser UI
  // does not hold — exclude them from task submission
  const collabOpts = collabs.data.filter((c) => !c.encrypted).map(
    (c) => `<option value="${Number(c.id)}">${esc(c.name)}</option>`).join("");
  keepSelection($("t_collab"), collabOpts);
  keepSelection($("st_collab"), collabOpts);
  keepSelection($("se_collab"), collabOpts);
  fillStudyOrgs();
  // only studies/sessions OF the selected collaboration: anything else
  // would 400 at submit ("study not in collaboration")
  const tc = parseInt($("t_collab").value, 10);
  keepSelection($("t_study"),
    `<option value="">whole collaboration</option>` +
    studies.data.filter((s) => s.collaboration === tc).map((s) =>
      `<option value="${Number(s.id)}">${esc(s.name)}</option>`).join(""));
  keepSelection($("t_session"),
    `<option value="">no session</option>` +
    sessions.data.filter((s) => s.collaboration.id === tc).map((s) =>
      `<option value="${Number(s.id)}">${esc(s.name)}</option>`).join(""));
  fill("studies", studies.data, (s) =>
    `<tr><td>${Number(s.id)}</td><td>${esc(s.name)}</td>` +
    `<td>${esc(s.collaboration)}</td>` +
    `<td>${esc((s.organizations || []).join(", "))}</td></tr>`);
  fill("sessions", sessions.data, (s) =>
    `<tr><td>${Number(s.id)}</td><td>${esc(s.name)}</td>` +
    `<td>${esc(s.collaboration.id)}</td><td>${esc(s.scope)}</td>` +
    `<td>${esc((s.dataframes || []).map((d) =>
        d.handle + (d.ready ? " ✓" : " …")).join(", "))}</td>` +
    `<td><button class="ghost" onclick="deleteSession(${Number(s.id)})">` +
    `delete</button></td></tr>`);
  fill("tasks", tasks.data.slice().reverse(), (t) =>
    `<tr><td><a onclick="showTask(${Number(t.id)})">${Number(t.id)}</a></td>` +
    `<td>${esc(t.name)}</td><td>${esc(t.image)}</td>` +
    `<td>${esc(t.method || "")}</td><td>${badge(t.status)}</td>` +
    // terminal-only states hide the button; a failed sibling run still
    // leaves OTHER runs consuming nodes, so failure states keep it
    `<td>${["completed", "killed by user"].includes(t.status) ? "" :
      `<button class="ghost" onclick="killTask(${Number(t.id)})">kill` +
      `</button>`}</td></tr>`);
}

window.killTask = async function (id) {
  try {
    $("taskerr").textContent = "";
    await api("POST", "kill/task", { task_id: id });
    await refresh();
  } catch (e) { $("taskerr").textContent = e.message; }
};

function fillStudyOrgs() {
  const collab = collabCache.find(
    (c) => c.id === parseInt($("st_collab").value, 10));
  keepSelection($("st_orgs"), (collab ? collab.organizations : []).map(
    (id) => `<option value="${Number(id)}">org ${Number(id)}</option>`
  ).join(""));
}
$("st_collab").onchange = fillStudyOrgs;
$("t_collab").onchange = () => {
  // org-typed wizard inputs and the study/session dropdowns are all scoped
  // to the selected collaboration — rebuild them on switch
  renderWizardArgs();
  refresh().catch(() => {});
};

let runCache = [];
window.showTask = async function (id) {
  const runs = await api("GET", `task/${id}/run`);
  runCache = runs.data;
  $("d_id").textContent = id;
  $("detailpanel").classList.remove("hidden");
  const dur = (a, b) => (a && b) ? `${(b - a).toFixed(2)}s` : "—";
  fill("runs", runs.data, (r) =>
    `<tr><td>${Number(r.id)}</td><td>${esc(r.organization.id)}</td>` +
    `<td>${esc(r.node && r.node.id ? r.node.id : "—")}</td>` +
    `<td>${badge(r.status)}</td>` +
    `<td>queued ${dur(r.assigned_at, r.started_at)}, ` +
    `ran ${dur(r.started_at, r.finished_at)}</td>` +
    `<td><a onclick="showRunLog(${Number(r.id)})">log / result</a></td></tr>`);
};

// full-content run viewer (the table truncates nothing — it links here)
window.showRunLog = function (id) {
  const r = runCache.find((x) => x.id === id);
  if (!r) return;
  $("rl_id").textContent = id;
  const ts = (t) => t ? new Date(t * 1000).toISOString() : "—";
  $("rl_meta").textContent =
    `org ${r.organization.id} · ${r.status} · assigned ${ts(r.assigned_at)}` +
    ` · started ${ts(r.started_at)} · finished ${ts(r.finished_at)}`;
  $("rl_log").textContent = r.log || "(empty)";
  $("rl_result").textContent = r.result || "(no result)";
  $("runlogpanel").classList.remove("hidden");
};

// ------------------------------------------------------------------- tabs
let activeTab = "overview";
document.querySelectorAll(".tabbtn").forEach((b) => {
  b.onclick = () => switchTab(b.dataset.tab);
});
function switchTab(tab) {
  activeTab = tab;
  for (const t of ["overview", "admin", "store"]) {
    $("tab_" + t).classList.toggle("hidden", t !== tab);
    document.querySelector(`.tabbtn[data-tab=${t}]`)
      .classList.toggle("ghost", t !== tab);
  }
  if (tab === "admin") refreshAdmin().catch(() => {});
  if (tab === "store") refreshStore().catch(() => {});
}

// ------------------------------------------------------------------ admin
let ruleCache = [], roleCache = [], userCache = [];

async function refreshAdmin() {
  const [orgs, users, roles, rules] = await Promise.all([
    api("GET", "organization"), api("GET", "user"),
    api("GET", "role"), api("GET", "rule?per_page=500"),
  ]);
  ruleCache = rules.data; roleCache = roles.data; userCache = users.data;
  fill("a_orgs", orgs.data, (o) =>
    `<tr><td>${Number(o.id)}</td><td>${esc(o.name)}</td>` +
    `<td>${esc(o.country || "")}</td>` +
    `<td>${o.public_key ? "yes" : "—"}</td></tr>`);
  const roleName = Object.fromEntries(roles.data.map((r) => [r.id, r.name]));
  fill("a_users", users.data, (u) =>
    `<tr><td>${Number(u.id)}</td>` +
    `<td><a onclick="showUser(${Number(u.id)})">${esc(u.username)}</a></td>` +
    `<td>${esc(u.email || "")}</td><td>${esc(u.organization.id)}</td>` +
    `<td>${esc((u.roles || []).map((r) => roleName[r] || r).join(", "))}</td>` +
    `<td><button class="ghost" onclick="deleteUser(${Number(u.id)})">` +
    `delete</button></td></tr>`);
  fill("a_roles", roles.data, (r) =>
    `<tr><td>${Number(r.id)}</td>` +
    `<td><a onclick="showRole(${Number(r.id)})">${esc(r.name)}</a></td>` +
    `<td>${esc(r.organization ? r.organization.id : "global")}</td>` +
    `<td>${Number((r.rules || []).length)}</td>` +
    `<td><a onclick="showRole(${Number(r.id)})">manage</a></td></tr>`);
  const orgOpts = orgs.data.map(
    (o) => `<option value="${Number(o.id)}">${esc(o.name)}</option>`).join("");
  $("u_org").innerHTML = orgOpts;
  $("r_org").innerHTML = `<option value="">global</option>` + orgOpts;
  $("u_roles").innerHTML = roles.data.map(
    (r) => `<option value="${Number(r.id)}">${esc(r.name)}</option>`).join("");
  $("r_rules").innerHTML = rules.data.map((r) =>
    `<option value="${Number(r.id)}">` +
    `${esc(r.name)}:${esc(r.scope)}:${esc(r.operation)}</option>`).join("");
}

window.deleteUser = async function (id) {
  try { await api("DELETE", `user/${id}`); await refreshAdmin(); }
  catch (e) { $("usererr").textContent = e.message; }
};

// ------------------------------------------------- role & user management
let shownRole = null, shownUser = null;

window.showRole = function (id) {
  const role = roleCache.find((r) => r.id === id);
  if (!role) return;
  shownRole = id;
  $("rd_name").textContent =
    `${role.name} (${role.organization ? "org " + role.organization.id
                                       : "global"})`;
  const ruleById = Object.fromEntries(ruleCache.map((r) => [r.id, r]));
  fill("rd_rules", role.rules || [], (rid) => {
    const r = ruleById[rid] || { name: rid, scope: "?", operation: "?" };
    return `<tr><td>${esc(r.name)}</td><td>${esc(r.scope)}</td>` +
      `<td>${esc(r.operation)}</td></tr>`;
  });
  const held = new Set(role.rules || []);
  $("rd_edit_rules").innerHTML = ruleCache.map((r) =>
    `<option value="${Number(r.id)}"${held.has(r.id) ? " selected" : ""}>` +
    `${esc(r.name)}:${esc(r.scope)}:${esc(r.operation)}</option>`).join("");
  $("rd_msg").textContent = ""; $("rd_err").textContent = "";
  $("roledetail").classList.remove("hidden");
};

$("rd_save").onclick = async () => {
  if (shownRole === null) return;
  try {
    $("rd_err").textContent = "";
    await api("PATCH", `role/${shownRole}`,
      { rules: selected("rd_edit_rules") });
    $("rd_msg").textContent = "rules updated";
    await refreshAdmin();
    showRole(shownRole);
  } catch (e) { $("rd_err").textContent = e.message; }
};

$("rd_delete").onclick = async () => {
  if (shownRole === null) return;
  try {
    $("rd_err").textContent = "";
    await api("DELETE", `role/${shownRole}`);
    $("roledetail").classList.add("hidden");
    shownRole = null;
    await refreshAdmin();
  } catch (e) { $("rd_err").textContent = e.message; }
};

window.showUser = function (id) {
  const u = userCache.find((x) => x.id === id);
  if (!u) return;
  shownUser = id;
  $("ud_name").textContent = `${u.username} (org ${u.organization.id})`;
  const held = new Set(u.roles || []);
  $("ud_roles").innerHTML = roleCache.map((r) =>
    `<option value="${Number(r.id)}"${held.has(r.id) ? " selected" : ""}>` +
    `${esc(r.name)}</option>`).join("");
  $("ud_msg").textContent = ""; $("ud_err").textContent = "";
  $("userdetail").classList.remove("hidden");
};

$("ud_save").onclick = async () => {
  if (shownUser === null) return;
  try {
    $("ud_err").textContent = "";
    await api("PATCH", `user/${shownUser}`,
      { roles: selected("ud_roles") });
    $("ud_msg").textContent = "roles updated";
    await refreshAdmin();
  } catch (e) { $("ud_err").textContent = e.message; }
};

const selected = (id) =>
  [...$(id).selectedOptions].map((o) => parseInt(o.value, 10));

$("o_create").onclick = async () => {
  try {
    $("orgerr").textContent = "";
    await api("POST", "organization",
      { name: $("o_name").value, country: $("o_country").value });
    $("o_name").value = "";
    await refreshAdmin();
  } catch (e) { $("orgerr").textContent = e.message; }
};

$("u_create").onclick = async () => {
  try {
    $("usererr").textContent = "";
    await api("POST", "user", {
      username: $("u_name").value, password: $("u_pass").value,
      email: $("u_email").value || null,
      organization_id: parseInt($("u_org").value, 10),
      roles: selected("u_roles"),
    });
    $("u_name").value = ""; $("u_pass").value = "";
    await refreshAdmin();
  } catch (e) { $("usererr").textContent = e.message; }
};

$("r_create").onclick = async () => {
  try {
    $("roleerr").textContent = "";
    await api("POST", "role", {
      name: $("r_name").value,
      organization_id: $("r_org").value ?
        parseInt($("r_org").value, 10) : null,
      rules: selected("r_rules"),
    });
    $("r_name").value = "";
    await refreshAdmin();
  } catch (e) { $("roleerr").textContent = e.message; }
};

$("pw_change").onclick = async () => {
  try {
    $("pwerr").textContent = ""; $("pw_msg").textContent = "";
    await api("POST", "password/change", {
      current_password: $("pw_current").value,
      new_password: $("pw_new").value,
    });
    $("pw_current").value = ""; $("pw_new").value = "";
    $("pw_msg").textContent = "password updated";
  } catch (e) { $("pwerr").textContent = e.message; }
};

// ------------------------------------------------------------------ store
async function refreshStore() {
  $("storeerr").textContent = "";
  const info = await api("GET", "store");
  if (!info.url) {
    $("s_url").textContent = "(no store linked)";
    fill("s_algos", [], () => ""); return;
  }
  $("s_url").textContent = info.url;
  try {
    const status = $("s_status").value;
    const algos = await api("GET", "store/algorithm" +
      (status ? `?status=${encodeURIComponent(status)}` : ""));
    storeAlgoCache = algos.data;
    fill("s_algos", algos.data, (a) =>
      `<tr><td><a onclick="showStoreAlgo(${Number(a.id)})">` +
      `${Number(a.id)}</a></td><td>${esc(a.name)}</td>` +
      `<td>${esc(a.image)}</td><td>${badge(a.status)}</td>` +
      `<td>${esc((a.functions || []).map((f) => f.name).join(", "))}</td>` +
      `</tr>`);
  } catch (e) { $("storeerr").textContent = e.message; }
}
$("s_status").onchange = () => refreshStore().catch(() => {});

$("sa_submit").onclick = async () => {
  try {
    $("saerr").textContent = ""; $("sa_msg").textContent = "";
    const fns = $("sa_functions").value.trim();
    await api("POST", "store/algorithm", {
      name: $("sa_name").value,
      image: $("sa_image").value,
      description: $("sa_desc").value,
      functions: fns ? JSON.parse(fns) : [],
    });
    $("sa_msg").textContent = "submitted — awaiting review";
    $("sa_name").value = ""; $("sa_image").value = "";
    await refreshStore();
  } catch (e) { $("saerr").textContent = e.message; }
};

let storeAlgoCache = [], shownStoreAlgo = null;
window.showStoreAlgo = async function (id) {
  const a = storeAlgoCache.find((x) => x.id === id);
  if (!a) return;
  shownStoreAlgo = id;
  $("s_d_name").textContent = `${a.name} (${a.image})`;
  $("s_d_desc").textContent = a.description || "";
  $("s_d_msg").textContent = ""; $("s_d_err").textContent = "";
  $("s_detailpanel").classList.remove("hidden");
  fill("s_d_functions", a.functions || [], (f) =>
    `<tr><td>${esc(f.display_name || f.name)}</td><td>${esc(f.type)}</td>` +
    `<td>${esc((f.arguments || []).map((x) =>
        `${x.name}:${x.type}${x.has_default ? "?" : ""}`).join(", "))}</td>` +
    `<td>${esc((f.databases || []).map((d) => d.name).join(", "))}</td>` +
    `</tr>`);
  await refreshStoreReviews(id);
};

async function refreshStoreReviews(algoId) {
  try {
    const reviews = await api("GET", `store/review?algorithm_id=${algoId}`);
    fill("s_d_reviews", reviews.data, (r) =>
      `<tr><td>${Number(r.id)}</td><td>${esc(r.reviewer)}</td>` +
      `<td>${badge(r.status)}</td><td>${esc(r.comment || "")}</td>` +
      `<td>${r.status === "under review" ?
        `<button onclick="decideReview(${Number(r.id)},'approved')">` +
        `approve</button> ` +
        `<button class="ghost" ` +
        `onclick="decideReview(${Number(r.id)},'rejected')">reject</button>`
        : ""}</td></tr>`);
  } catch (e) {
    // the review ledger needs a trusted-server token; browsing the public
    // registry must keep working without it
    fill("s_d_reviews", [], () => "");
    $("s_d_err").textContent = e.message;
  }
}

$("s_d_startreview").onclick = async () => {
  if (shownStoreAlgo === null) return;
  try {
    $("s_d_err").textContent = "";
    await api("POST", `store/algorithm/${shownStoreAlgo}/review`);
    $("s_d_msg").textContent = "review opened — decide below";
    await refreshStoreReviews(shownStoreAlgo);
    await refreshStore();
  } catch (e) { $("s_d_err").textContent = e.message; }
};

window.decideReview = async function (reviewId, verdict) {
  try {
    $("s_d_err").textContent = "";
    await api("PATCH", `store/review/${reviewId}`, {
      status: verdict, comment: $("s_d_comment").value,
    });
    $("s_d_msg").textContent = `review ${verdict}`;
    await refreshStoreReviews(shownStoreAlgo);
    await refreshStore();
  } catch (e) { $("s_d_err").textContent = e.message; }
};

async function enter() {
  $("login").classList.add("hidden");
  $("appview").classList.remove("hidden");
  $("logout").classList.remove("hidden");
  await refresh();
  loadWizardAlgos();  // once per session; the 3 s poll must not hit the store
}

$("signin").onclick = async () => {
  try {
    const data = await api("POST", "token/user", {
      username: $("username").value,
      password: $("password").value,
      mfa_code: $("mfa").value || null,
    });
    token = data.access_token;
    sessionStorage.setItem("v6t_token", token);
    $("whoami").textContent = data.user.username;
    await enter();
  } catch (e) { $("loginerr").textContent = e.message; }
};

$("logout").onclick = () => {
  sessionStorage.removeItem("v6t_token"); location.reload();
};

// --------------------------------------------------- task wizard (store)
// Approved store algorithms carry full function/argument metadata
// (reference: the Angular UI's "task wizard" builds its form from exactly
// this); picking one swaps the freeform inputs for a typed form.
let wizardAlgos = [];

async function loadWizardAlgos() {
  try {
    const info = await api("GET", "store");
    if (!info.url) return;
    const algos = await api("GET", "store/algorithm");
    wizardAlgos = algos.data.filter((a) => a.status === "approved");
    $("t_algo").innerHTML = `<option value="">freeform algorithm</option>` +
      wizardAlgos.map((a) =>
        `<option value="${Number(a.id)}">${esc(a.name)} (${esc(a.image)})` +
        `</option>`).join("");
  } catch (e) { /* store unreachable: freeform still works */ }
}

function wizardAlgo() {
  return wizardAlgos.find((a) => a.id === parseInt($("t_algo").value, 10));
}

$("t_algo").onchange = () => {
  const algo = wizardAlgo();
  $("t_freeform").classList.toggle("hidden", !!algo);
  $("t_wizard").classList.toggle("hidden", !algo);
  if (!algo) return;
  $("w_function").innerHTML = (algo.functions || []).map((f) =>
    `<option value="${esc(f.name)}">${esc(f.display_name || f.name)}` +
    ` [${esc(f.type)}]</option>`).join("");
  renderWizardArgs();
};
$("w_function").onchange = () => renderWizardArgs();

function wizardFunction() {
  const algo = wizardAlgo();
  return algo && (algo.functions || []).find(
    (f) => f.name === $("w_function").value);
}

function argInput(a) {
  const id = `wa_${esc(a.name)}`;
  const ph = esc(a.display_name || a.name) +
    (a.has_default ? ` (default ${esc(JSON.stringify(a.default))})` : "");
  const title = esc(a.description || a.name);
  if (a.type === "boolean")
    return `<label title="${title}"><input type="checkbox" id="${id}"` +
      `${a.default ? " checked" : ""}> ${esc(a.name)}</label>`;
  if (a.type === "organization" || a.type === "organization_list") {
    const collab = collabCache.find(
      (c) => c.id === parseInt($("t_collab").value, 10));
    const opts = (collab ? collab.organizations : []).map(
      (o) => `<option value="${Number(o)}">org ${Number(o)}</option>`).join("");
    const multi = a.type === "organization_list" ? " multiple size=3" : "";
    return `<select id="${id}" title="${title}"${multi}>${opts}</select>`;
  }
  // "string" and "column" are free text; "integer"/"float" parse at submit
  const size = a.type === "json" ? 28 :
    (a.type === "string" || a.type === "column") ? 16 :
    (a.type === "integer" || a.type === "float") ? 8 : 14;
  return `<input id="${id}" placeholder="${ph}" title="${title}"` +
    ` size="${size}">`;
}

function renderWizardArgs() {
  const fn = wizardFunction();
  $("w_fndesc").textContent = fn ? (fn.description || "") : "";
  $("w_args").innerHTML =
    (fn ? fn.arguments || [] : []).map(argInput).join(" ");
}

function wizardKwargs() {
  const fn = wizardFunction();
  const kwargs = {};
  for (const a of fn.arguments || []) {
    const el = $(`wa_${a.name}`);
    if (!el) continue;
    if (a.type === "boolean") { kwargs[a.name] = el.checked; continue; }
    if (a.type === "organization_list") {
      const ids = [...el.selectedOptions].map((o) => parseInt(o.value, 10));
      if (ids.length || !a.has_default) kwargs[a.name] = ids;
      continue;
    }
    const raw = el.value.trim();
    if (!raw) {
      if (!a.has_default)
        throw new Error(`argument "${a.name}" is required`);
      continue;  // omitted: the algorithm applies its default
    }
    if (a.type === "integer" || a.type === "organization")
      kwargs[a.name] = parseInt(raw, 10);
    else if (a.type === "float") kwargs[a.name] = parseFloat(raw);
    else if (a.type === "json") kwargs[a.name] = JSON.parse(raw);
    else kwargs[a.name] = raw;  // string | column
  }
  return kwargs;
}

$("t_create").onclick = async () => {
  try {
    $("taskerr").textContent = "";
    const algo = wizardAlgo();
    let image, method, kwargs;
    if (algo) {
      image = algo.image;
      method = $("w_function").value;
      kwargs = wizardKwargs();
    } else {
      image = $("t_image").value;
      method = $("t_method").value;
      kwargs = $("t_kwargs").value.trim() ?
        JSON.parse($("t_kwargs").value) : {};
    }
    const collab = parseInt($("t_collab").value, 10);
    const studyId = $("t_study").value ?
      parseInt($("t_study").value, 10) : null;
    let orgs;
    if (studyId) {
      orgs = (await api("GET", `study/${studyId}`)).organizations;
    } else {
      orgs = (await api("GET", `collaboration/${collab}`)).organizations;
    }
    const input = { method, kwargs };
    // unencrypted collaborations: plain base64 payload per org
    const blob = btoa(JSON.stringify(input));
    const body = {
      name: "ui task", image, method, collaboration_id: collab,
      organizations: orgs.map((id) => ({ id, input: blob })),
    };
    if (studyId) body.study_id = studyId;
    if ($("t_session").value) {
      body.session_id = parseInt($("t_session").value, 10);
      if ($("t_store_as").value.trim())
        body.store_as = $("t_store_as").value.trim();
    }
    await api("POST", "task", body);
    await refresh();
  } catch (e) { $("taskerr").textContent = e.message; }
};

// ----------------------------------------------------- studies & sessions
$("st_create").onclick = async () => {
  try {
    $("studyerr").textContent = "";
    await api("POST", "study", {
      name: $("st_name").value,
      collaboration_id: parseInt($("st_collab").value, 10),
      organization_ids: selected("st_orgs"),
    });
    $("st_name").value = "";
    await refresh();
  } catch (e) { $("studyerr").textContent = e.message; }
};

$("se_create").onclick = async () => {
  try {
    $("sesserr").textContent = "";
    await api("POST", "session", {
      name: $("se_name").value,
      collaboration_id: parseInt($("se_collab").value, 10),
      scope: $("se_scope").value,
    });
    $("se_name").value = "";
    await refresh();
  } catch (e) { $("sesserr").textContent = e.message; }
};

window.deleteSession = async function (id) {
  try { await api("DELETE", `session/${id}`); await refresh(); }
  catch (e) { $("sesserr").textContent = e.message; }
};

api("GET", "version").then((v) => $("version").textContent = "v" + v.version);
if (token) {
  api("GET", "whoami").then((w) => {
    $("whoami").textContent = w.username; enter();  // textContent: no XSS
  }).catch(() => { token = null; sessionStorage.removeItem("v6t_token"); });
}
setInterval(() => { if (token && !$("appview").classList.contains("hidden"))
  refresh().catch(() => {}); }, 3000);
</script>
</body>
</html>
"""


def register_ui(srv: "ServerApp") -> None:
    app = srv.app

    @app.route("/")
    @app.route("/ui")
    def ui(req: Request):
        return Response(
            PAGE.encode(), headers={"Content-Type": "text/html; charset=utf-8"}
        )
