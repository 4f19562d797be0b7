"""Projects, project secrets, and datastore profiles (reference:
crud/projects.py + follower leader-first flow;
endpoints/secrets.py — values are write/delete-only over REST;
server-side datastore_profile endpoints — private fields go to the
project-secret store and are never returned)."""

from __future__ import annotations

import asyncio

from aiohttp import web

from ..http_utils import API, error_response, json_response


def register(r: web.RouteTableDef, state):
    @r.post(API + "/projects/{name}")
    async def store_project(request):
        body = await request.json()
        name = request.match_info["name"]
        if state.projects_follower.enabled:
            # leader-first (reference follower.py create/store flow)
            loop = asyncio.get_event_loop()
            try:
                stored = await loop.run_in_executor(
                    None,
                    lambda: state.projects_follower.forward_store(name,
                                                                  body))
            except Exception as exc:  # noqa: BLE001
                return error_response(f"project leader rejected: {exc}",
                                      502)
            return json_response({"data": stored})
        stored = state.db.store_project(name, body)
        return json_response({"data": stored})

    @r.get(API + "/projects/{name}")
    async def get_project(request):
        project = state.db.get_project(request.match_info["name"])
        if project is None:
            return error_response("project not found", 404)
        return json_response({"data": project})

    @r.get(API + "/projects")
    async def list_projects(request):
        return json_response({"projects": state.db.list_projects(
            state=request.query.get("state"))})

    @r.delete(API + "/projects/{name}")
    async def delete_project(request):
        from ...db.base import RunDBError

        name = request.match_info["name"]
        strategy = request.query.get("deletion_strategy", "restricted")
        try:
            if state.projects_follower.enabled:
                loop = asyncio.get_event_loop()
                await loop.run_in_executor(
                    None,
                    lambda: state.projects_follower.forward_delete(
                        name, deletion_strategy=strategy))
            else:
                state.db.delete_project(name, deletion_strategy=strategy)
        except RunDBError as exc:
            return error_response(str(exc), 412)
        return json_response({"ok": True})

    # -- project secrets ----------------------------------------------------
    @r.post(API + "/projects/{project}/secrets")
    async def store_project_secrets(request):
        body = await request.json()
        provider = body.get("provider", "kubernetes")
        secrets = body.get("secrets") or {}
        if not isinstance(secrets, dict):
            return error_response("secrets must be a mapping")
        state.db.store_project_secrets(
            request.match_info["project"], secrets, provider=provider)
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/secret-keys")
    async def list_project_secret_keys(request):
        provider = request.query.get("provider", "kubernetes")
        keys = state.db.list_project_secret_keys(
            request.match_info["project"], provider=provider)
        return json_response({"secret_keys": keys})

    @r.delete(API + "/projects/{project}/secrets")
    async def delete_project_secrets(request):
        provider = request.query.get("provider", "kubernetes")
        keys = request.query.getall("secret", []) or None
        project = request.match_info["project"]
        state.db.delete_project_secrets(project, keys=keys,
                                        provider=provider)
        if keys is None and provider == "kubernetes":
            # full wipe: also remove the projected k8s Secret (best-effort;
            # the provider is gated on the kubernetes package)
            try:
                from ..runtime_handlers import KubernetesProvider

                KubernetesProvider().delete_project_secret(project)
            except Exception:  # noqa: BLE001 - no cluster / not deployed
                pass
        return json_response({"ok": True})

    # -- datastore profiles -------------------------------------------------
    @r.put(API + "/projects/{project}/datastore-profiles/{name}")
    async def store_datastore_profile(request):
        body = await request.json()
        profile = body.get("profile") or {}
        profile["name"] = request.match_info["name"]
        state.db.store_datastore_profile(
            profile, request.match_info["project"],
            private=body.get("private") or None)
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/datastore-profiles/{name}")
    async def get_datastore_profile(request):
        profile = state.db.get_datastore_profile(
            request.match_info["name"], request.match_info["project"])
        if profile is None:
            return error_response("datastore profile not found", 404)
        return json_response({"data": profile})

    @r.get(API + "/projects/{project}/datastore-profiles")
    async def list_datastore_profiles(request):
        return json_response({"datastore_profiles":
                              state.db.list_datastore_profiles(
                                  request.match_info["project"])})

    @r.delete(API + "/projects/{project}/datastore-profiles/{name}")
    async def delete_datastore_profile(request):
        state.db.delete_datastore_profile(
            request.match_info["name"], request.match_info["project"])
        return json_response({"ok": True})
