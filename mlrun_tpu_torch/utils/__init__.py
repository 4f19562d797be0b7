"""Host utilities of the port (the reference's ``utils`` names)."""

from .helpers import (  # noqa: F401
    as_list,
    dict_to_yaml,
    enrich_image_url,
    fill_run_metadata,
    generate_uid,
    get_in,
    is_relative_path,
    new_pipe_metadata,
    normalize_name,
    now_date,
    now_iso,
    retry_until_successful,
    template_artifact_path,
    update_in,
    verify_field_regex,
)
from .logger import logger  # noqa: F401

from ..secrets import get_secret_or_env  # noqa: F401, E402
