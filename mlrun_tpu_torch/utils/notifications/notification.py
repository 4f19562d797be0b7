"""Notification backends — the port's copy of
``mlrun_tpu/utils/notifications/notification.py`` (console, slack, webhook,
mail, ipython, git), with the reference's payloads. The HTTP ones post
through the standard library (``serving.remote.http_request`` over
``urllib.request``): the card's machine has no ``requests``."""

from __future__ import annotations

import os


def _http(method: str, url: str, payload: dict, headers: dict | None = None):
    from ...serving.remote import http_request

    return http_request(method, url, headers=headers, timeout=10,
                        json_body=payload)


class NotificationBase:
    kind = "base"

    def __init__(self, name: str = "", params: dict | None = None):
        self.name = name
        self.params = params or {}

    def push(self, message: str, severity: str = "info",
             runs: list | None = None):
        raise NotImplementedError

    @staticmethod
    def _runs_summary(runs: list | None) -> str:
        lines = []
        for run in runs or []:
            meta = run.get("metadata", {})
            status = run.get("status", {})
            lines.append(
                f"- {meta.get('project')}/{meta.get('name')} "
                f"[{status.get('state')}] results={status.get('results')}")
        return "\n".join(lines)


class ConsoleNotification(NotificationBase):
    kind = "console"

    def push(self, message, severity="info", runs=None):
        print(f"[{severity}] {message}")
        summary = self._runs_summary(runs)
        if summary:
            print(summary)


class SlackNotification(NotificationBase):
    kind = "slack"

    def push(self, message, severity="info", runs=None):
        webhook = self.params.get("webhook")
        if not webhook:
            raise ValueError("slack notification requires a 'webhook' param")
        blocks = [{"type": "section",
                   "text": {"type": "mrkdwn",
                            "text": f"*{severity}*: {message}"}}]
        summary = self._runs_summary(runs)
        if summary:
            blocks.append({"type": "section",
                           "text": {"type": "mrkdwn", "text": summary}})
        _http("POST", webhook, {"blocks": blocks})


class WebhookNotification(NotificationBase):
    kind = "webhook"

    def push(self, message, severity="info", runs=None):
        url = self.params.get("url")
        if not url:
            raise ValueError("webhook notification requires a 'url' param")
        _http(self.params.get("method", "POST").upper(), url,
              {"message": message, "severity": severity, "runs": runs or []},
              headers=self.params.get("headers", {}))


class MailNotification(NotificationBase):
    kind = "mail"

    def push(self, message, severity="info", runs=None):
        import smtplib
        from email.message import EmailMessage

        msg = EmailMessage()
        msg["Subject"] = f"[mlrun-tpu][{severity}] {message}"
        msg["From"] = self.params.get("from", "mlrun-tpu@localhost")
        msg["To"] = self.params.get("to", "")
        msg.set_content(self._runs_summary(runs) or message)
        host = self.params.get("server_host", "localhost")
        port = int(self.params.get("server_port", 25))
        with smtplib.SMTP(host, port, timeout=10) as server:
            server.send_message(msg)


class IPythonNotification(NotificationBase):
    kind = "ipython"

    def push(self, message, severity="info", runs=None):
        try:
            from IPython.display import display_markdown

            display_markdown(f"**{severity}**: {message}", raw=True)
        except ImportError:
            print(f"[{severity}] {message}")


class GitNotification(NotificationBase):
    """Comment on a GitHub/GitLab issue or merge request (params: repo,
    issue, token; the server picked via the ``server`` param)."""

    kind = "git"

    def push(self, message, severity="info", runs=None):
        from urllib.parse import quote

        repo = self.params.get("repo", "")
        issue = self.params.get("issue", "")
        token = (self.params.get("token")
                 or os.environ.get("GIT_TOKEN", ""))
        if not (repo and issue and token):
            raise ValueError(
                "git notification requires 'repo', 'issue' and 'token' "
                "params (or GIT_TOKEN env)")
        body = f"[{severity}] {message}"
        summary = self._runs_summary(runs)
        if summary:
            body += "\n\n" + summary
        server = self.params.get("server", "")
        # the provider must be explicit for self-hosted servers: inferring
        # it from the hostname would silently treat a GitLab on a custom
        # domain as GitHub Enterprise and post the token to a nonexistent
        # /api/v3 endpoint in a GitHub-style header
        provider = self.params.get("provider", "")
        if provider not in ("", "github", "gitlab"):
            raise ValueError(
                f"git notification provider must be 'github' or 'gitlab', "
                f"got {provider!r}")
        if not provider:
            if self.params.get("gitlab"):  # legacy param
                provider = "gitlab"
            elif not server:
                provider = "github"  # github.com default
            elif server in ("gitlab.com", "github.com"):
                provider = server.split(".")[0]
            else:
                raise ValueError(
                    "git notification to a self-hosted server requires an "
                    "explicit provider='github'|'gitlab' param")
        if provider == "gitlab":
            url = (f"https://{server or 'gitlab.com'}/api/v4/projects/"
                   f"{quote(repo, safe='')}/issues/"
                   f"{issue}/notes")
            headers = {"PRIVATE-TOKEN": token}
            payload = {"body": body}
        else:
            # github.com API lives on its own host; GitHub Enterprise
            # serves it under /api/v3 on the instance host
            api_base = (f"https://{server}/api/v3" if server
                        else "https://api.github.com")
            url = f"{api_base}/repos/{repo}/issues/{issue}/comments"
            headers = {"Authorization": f"token {token}",
                       "Accept": "application/vnd.github.v3+json"}
            payload = {"body": body}
        _http("POST", url, payload, headers=headers).raise_for_status()


notification_types: dict[str, type] = {
    "console": ConsoleNotification,
    "slack": SlackNotification,
    "webhook": WebhookNotification,
    "mail": MailNotification,
    "ipython": IPythonNotification,
    "git": GitNotification,
}
