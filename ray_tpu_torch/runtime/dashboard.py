"""Dashboard: the head's HTTP observability surface.

Reference parity: the reference runs a dashboard web server on the head
(aiohttp app + per-node agents) exposing cluster state — nodes, actors,
tasks, objects, placement groups, jobs — alongside the metrics/state
APIs (``python/ray/dashboard/`` — SURVEY.md §1 layer 12, §2.2; mount
empty).  This rebuild's version is a dependency-free stdlib HTTP server
in the head/driver process:

- ``GET /``                      one-page HTML overview (auto-refresh)
- ``GET /api/summary``           cluster totals (resources, tasks, actors,
                                 store, nodes)
- ``GET /api/nodes|actors|tasks|objects|placement_groups``
                                 state-API rows as JSON
- ``GET /api/jobs``              submitted jobs (when a JobManager is
                                 attached, i.e. under the head daemon)
- ``GET /api/timeline``          Chrome-trace events
- ``GET /metrics``               Prometheus text (same renderer as the
                                 ``metrics_export_port`` endpoint)

Enabled by the ``dashboard_port``/``dashboard_host`` config knobs
(port 0 disables).  Everything is computed at request time from live
runtime objects — no collector thread.
"""

from __future__ import annotations

import html
import json
from collections import Counter

from .http_server import BackgroundHTTPServer


class Dashboard(BackgroundHTTPServer):
    def __init__(self, cluster, port: int = 0,
                 host: str = "127.0.0.1", job_manager=None):
        self._cluster = cluster
        self._jobs = job_manager
        super().__init__(host=host, port=port, name="dashboard")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def attach_jobs(self, job_manager) -> None:
        self._jobs = job_manager

    # -- routing -------------------------------------------------------------
    def route(self, request) -> None:
        path = request.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/":
            self.reply(request, self._render_index().encode(),
                       "text/html; charset=utf-8")
            return
        if path == "/metrics":
            from .metrics import render_metrics
            self.reply(request, render_metrics(self._cluster).encode(),
                       "text/plain; version=0.0.4")
            return
        if path.startswith("/api/"):
            payload = self._api(path[len("/api/"):])
            if payload is not None:
                self.reply(request, json.dumps(payload).encode(),
                           "application/json")
                return
        self.not_found(request)

    # -- data ----------------------------------------------------------------
    def _api(self, name: str):
        from ..util import state
        if name == "summary":
            return self._summary()
        if name == "nodes":
            return state.list_nodes()
        if name == "actors":
            return state.list_actors()
        if name == "tasks":
            return state.list_tasks()
        if name == "objects":
            return state.list_objects()
        if name == "placement_groups":
            return state.list_placement_groups()
        if name == "timeline":
            return self._cluster.events.timeline()
        if name == "stacks":
            # live all-thread stacks of every worker (py-spy analogue)
            got = self._cluster.dump_worker_stacks(timeout=5.0)
            return {f"{r}:{i}": text for (r, i), text in got.items()}
        if name == "jobs":
            return self._jobs.list() if self._jobs is not None else []
        if name == "leases":
            try:
                from ..leasing import aggregate_stats
                return aggregate_stats()
            except Exception:   # noqa: BLE001 — lease plane disabled
                return {}
        if name == "serve":
            out = {}
            try:
                from ..serve.router import request_plane_stats
                out["deployments"] = request_plane_stats()
            except Exception:   # noqa: BLE001 — serve absent/unused
                out["deployments"] = {}
            try:
                from ..serve.gossip import board
                out["gossip"] = board.stats()
            except Exception:   # noqa: BLE001
                pass
            loans = getattr(self._cluster, "loans", None)
            if loans is not None:
                out["loans"] = loans.stats()
            return out
        if name == "versions":
            try:
                from ..versioning import VersionRegistry
                return VersionRegistry().all()
            except Exception:   # noqa: BLE001 — versioning absent/unused
                return {}
        if name == "broadcasts":
            cluster = self._cluster
            out = {}
            broadcasts = getattr(cluster, "broadcasts", None)
            if broadcasts is not None:
                out.update(broadcasts.stats())
            plane = getattr(cluster, "plane", None)
            if plane is not None:
                out.update(plane.bcast.stats())
            return out
        if name == "health":
            from ..rpc import breaker, chaos
            cluster = self._cluster
            out = cluster.health.stats()
            out["suspect_rows"] = cluster.crm.suspect_rows()
            out["breakers"] = breaker.stats()
            out["chaos"] = chaos.status()
            plane = getattr(cluster, "plane", None)
            if plane is not None:
                out["blacklisted_sources"] = plane.blacklisted_sources()
            return out
        return None

    def _summary(self, nodes=None, actors=None, tasks=None) -> dict:
        """Rows may be passed in by a caller that already listed them
        (the index page) so one render never walks the state twice."""
        from .. import api
        from ..util import state
        nodes = state.list_nodes() if nodes is None else nodes
        actors = state.list_actors() if actors is None else actors
        tasks = state.list_tasks() if tasks is None else tasks
        task_counts = Counter(r["state"] for r in tasks)
        actor_counts = Counter(r["state"] for r in actors)
        return {
            "nodes": len(nodes),
            "cluster_resources": api.cluster_resources(),
            "available_resources": api.available_resources(),
            "tasks": {"total": len(tasks),
                      "by_state": dict(task_counts)},
            "actors": {"total": len(actors),
                       "by_state": dict(actor_counts)},
            "store": self._cluster.store.stats(),
            "jobs": (self._jobs.list() if self._jobs is not None else []),
        }

    # -- HTML ----------------------------------------------------------------
    def _render_index(self) -> str:
        from ..util import state
        nodes = state.list_nodes()
        actors = state.list_actors()
        tasks = state.list_tasks()
        pgs = state.list_placement_groups()
        s = self._summary(nodes=nodes, actors=actors, tasks=tasks)

        def table(rows: list[dict], columns: list[str]) -> str:
            head = "".join(f"<th>{html.escape(c)}</th>" for c in columns)
            body = []
            for r in rows[:200]:        # the UI is a summary, not a dump
                cells = "".join(
                    f"<td>{html.escape(str(r.get(c, '')))}</td>"
                    for c in columns)
                body.append(f"<tr>{cells}</tr>")
            more = (f"<p>… {len(rows) - 200} more (see the JSON API)</p>"
                    if len(rows) > 200 else "")
            return (f"<table><tr>{head}</tr>{''.join(body)}</table>{more}")

        def kv(d: dict) -> str:
            return ", ".join(f"{html.escape(str(k))}={html.escape(str(v))}"
                             for k, v in sorted(d.items())) or "—"

        sections = [
            "<h1>ray_tpu_torch dashboard</h1>",
            f"<p>{s['nodes']} nodes · {s['tasks']['total']} tasks "
            f"({kv(s['tasks']['by_state'])}) · "
            f"{s['actors']['total']} actors</p>",
            f"<p>cluster resources: {kv(s['cluster_resources'])}<br>"
            f"available: {kv(s['available_resources'])}</p>",
            f"<p>object store: {kv(s['store'])}</p>",
            "<h2>Nodes</h2>",
            table(nodes, ["node_id", "state", "row", "labels"]),
            "<h2>Actors</h2>",
            table(actors, ["actor_id", "name", "state", "pending_calls",
                           "inflight_calls"]),
            "<h2>Placement groups</h2>",
            table(pgs, ["placement_group_id", "state", "strategy",
                        "bundles"]),
        ]
        if self._jobs is not None:
            sections += ["<h2>Jobs</h2>",
                         table(s["jobs"],
                               ["job_id", "status", "entrypoint"])]
        try:
            from ..serve.router import request_plane_stats
            plane = request_plane_stats()
        except Exception:   # noqa: BLE001 — serve absent/unused
            plane = {}
        if plane:
            rows = [dict(v, deployment=k) for k, v in
                    sorted(plane.items())]
            sections += [
                "<h2>Serve request plane</h2>",
                table(rows, ["deployment", "replicas", "shards",
                             "inflight", "queued", "qps", "p50_ms",
                             "p99_ms", "shed", "expired",
                             "batch_size_mean"])]
            loans = getattr(self._cluster, "loans", None)
            if loans is not None:
                ls = loans.stats()
                sections.append(
                    f"<p>capacity loans: {ls['loans_active']} active · "
                    f"{ls['loans_total']} taken · "
                    f"{ls['reclaims_total']} reclaimed · "
                    f"{ls['loans_lost']} lost · last reclaim "
                    f"{ls['last_reclaim_latency_s']}s</p>")
        sections.append(
            '<p>APIs: <a href="/api/summary">summary</a> · '
            '<a href="/api/nodes">nodes</a> · '
            '<a href="/api/actors">actors</a> · '
            '<a href="/api/tasks">tasks</a> · '
            '<a href="/api/objects">objects</a> · '
            '<a href="/api/placement_groups">placement groups</a> · '
            '<a href="/api/serve">serve</a> · '
            '<a href="/api/versions">versions</a> · '
            '<a href="/api/leases">leases</a> · '
            '<a href="/api/broadcasts">broadcasts</a> · '
            '<a href="/api/health">health</a> · '
            '<a href="/api/stacks">stacks</a> · '
            '<a href="/api/timeline">timeline</a> · '
            '<a href="/api/jobs">jobs</a> · '
            '<a href="/metrics">metrics</a></p>')
        return ("<!doctype html><html><head>"
                '<meta http-equiv="refresh" content="5">'
                "<title>ray_tpu_torch dashboard</title>"
                "<style>body{font-family:monospace;margin:2em}"
                "table{border-collapse:collapse}"
                "td,th{border:1px solid #999;padding:2px 8px;"
                "text-align:left}</style>"
                "</head><body>" + "".join(sections) + "</body></html>")
