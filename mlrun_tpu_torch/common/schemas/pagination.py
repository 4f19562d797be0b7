"""Pagination schemas (reference analog: the pagination_cache model in
server/api/db/sqldb/models.py + paginated responses)."""

from __future__ import annotations

from typing import Optional

import pydantic


class PaginationInfo(pydantic.BaseModel):
    page_token: Optional[str] = None
    page_size: Optional[int] = None


class PaginatedResponse(pydantic.BaseModel):
    items: list = []
    pagination: PaginationInfo = PaginationInfo()
