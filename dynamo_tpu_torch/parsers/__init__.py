"""Tool-call + reasoning parsers and the streaming jail.

Reference subsystem: lib/parsers (tool_calling + reasoning registries) and
lib/llm/src/protocols/openai/chat_completions/jail.rs.

Copy of ``dynamo_tpu/parsers/__init__.py``.
"""

from dynamo_tpu_torch.parsers.jail import JailDelta, StreamJail
from dynamo_tpu_torch.parsers.reasoning import (
    REASONING_PARSERS,
    ParserResult,
    ReasoningConfig,
    ReasoningParser,
    get_reasoning_parser,
)
from dynamo_tpu_torch.parsers.tool_calls import (
    TOOL_PARSERS,
    ToolCall,
    ToolCallConfig,
    get_tool_parser,
    parse_tool_calls,
)

__all__ = [
    "JailDelta",
    "StreamJail",
    "REASONING_PARSERS",
    "ParserResult",
    "ReasoningConfig",
    "ReasoningParser",
    "get_reasoning_parser",
    "TOOL_PARSERS",
    "ToolCall",
    "ToolCallConfig",
    "get_tool_parser",
    "parse_tool_calls",
]
