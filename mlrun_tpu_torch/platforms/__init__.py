"""Pod mount modifiers — the port's copy of ``mlrun_tpu/platforms``:
each returns a function that adds a volume and its mount (and env) to
a runtime's pod spec, for ``fn.apply(...)``; ``auto_mount`` picks one
from the environment (a PVC, else a GCS key)."""

from __future__ import annotations

import os

from ..utils import logger


def mount_pvc(pvc_name: str = "", volume_name: str = "pvc",
              volume_mount_path: str = "/mnt/data"):
    """Mount a persistent volume claim on the runtime's pods."""
    pvc_name = pvc_name or os.environ.get("MLT_PVC_NAME", "")

    def modifier(runtime):
        if not pvc_name:
            raise ValueError("no pvc_name given (or MLT_PVC_NAME set)")
        runtime.spec.volumes.append({
            "name": volume_name,
            "persistentVolumeClaim": {"claimName": pvc_name},
        })
        runtime.spec.volume_mounts.append({
            "name": volume_name, "mountPath": volume_mount_path})
        return runtime

    return modifier


def mount_secret(secret_name: str, mount_path: str = "/secrets",
                 volume_name: str = "secret", items: list | None = None):
    def modifier(runtime):
        volume = {"name": volume_name, "secret": {"secretName": secret_name}}
        if items:
            volume["secret"]["items"] = items
        runtime.spec.volumes.append(volume)
        runtime.spec.volume_mounts.append({
            "name": volume_name, "mountPath": mount_path})
        return runtime

    return modifier


def mount_configmap(configmap_name: str, mount_path: str = "/config",
                    volume_name: str = "configmap"):
    def modifier(runtime):
        runtime.spec.volumes.append({
            "name": volume_name,
            "configMap": {"name": configmap_name},
        })
        runtime.spec.volume_mounts.append({
            "name": volume_name, "mountPath": mount_path})
        return runtime

    return modifier


def mount_gcs_key(secret_name: str = "gcs-credentials",
                  key_file: str = "key.json",
                  env_var: str = "GOOGLE_APPLICATION_CREDENTIALS"):
    """Mount a GCS service-account key and point the standard env at it
    (the object-store credential of the cloud's own buckets)."""

    def modifier(runtime):
        mount_path = "/var/secrets/gcs"
        runtime.spec.volumes.append({
            "name": "gcs-key", "secret": {"secretName": secret_name}})
        runtime.spec.volume_mounts.append({
            "name": "gcs-key", "mountPath": mount_path, "readOnly": True})
        runtime.set_env(env_var, f"{mount_path}/{key_file}")
        return runtime

    return modifier


def mount_tmpfs(size: str = "1Gi", mount_path: str = "/dev/shm",
                volume_name: str = "shm"):
    """RAM-backed scratch for host-side data loading."""

    def modifier(runtime):
        runtime.spec.volumes.append({
            "name": volume_name,
            "emptyDir": {"medium": "Memory", "sizeLimit": size},
        })
        runtime.spec.volume_mounts.append({
            "name": volume_name, "mountPath": mount_path})
        return runtime

    return modifier


def auto_mount(pvc_name: str = "", volume_mount_path: str = "/mnt/data"):
    """Pick a mount from the environment: a PVC, else a GCS key."""
    if pvc_name or os.environ.get("MLT_PVC_NAME"):
        return mount_pvc(pvc_name, volume_mount_path=volume_mount_path)
    if os.environ.get("GOOGLE_APPLICATION_CREDENTIALS"):
        return mount_gcs_key()

    def noop(runtime):
        logger.warning("auto_mount found nothing to mount")
        return runtime

    return noop
