"""Chat templating for the HTTP server's /v1/chat/completions endpoint.

Counterpart of `llama3np_tpu.chat`, the same host code (the port keeps its
own copy).  It renders an OpenAI-style ``messages`` list into one prompt
string for the engine's tokenizer.  The bundled tokenizer is the llama2.c
SentencePiece vocabulary, which has no chat special tokens, so every
template renders to PLAIN TEXT:

  * ``plain``: ``role: content`` lines and an ``assistant:`` cue; safe
    for base (non-chat) checkpoints such as stories15M.
  * ``llama2``: the llama-2-chat ``[INST] ... [/INST]`` format, the system
    prompt folded into the first user turn inside ``<<SYS>>``/``<</SYS>>``.
  * ``chatml``: ``<|im_start|>role\\n...<|im_end|>``.

A conversation's rendering is a string PREFIX of the same conversation
extended by more turns (the assistant's reply, then a new user turn), so
multi-turn chats hit the serving engine's page-granular prefix cache
(prefix.py): the follow-up request reuses every full page of the
history's KV instead of prefilling it again.
"""

from __future__ import annotations

from typing import Dict, List, Optional

Role = str  # "system" | "user" | "assistant"


def _validate(messages: List[Dict]) -> List[Dict]:
    if not messages:
        raise ValueError("messages must be non-empty")
    out = []
    for i, m in enumerate(messages):
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise ValueError(
                f"messages[{i}] must be {{'role': ..., 'content': ...}}")
        role, content = m["role"], m["content"]
        if role not in ("system", "user", "assistant"):
            raise ValueError(f"messages[{i}].role must be system/user/"
                             f"assistant, got {role!r}")
        if role == "system" and i != 0:
            raise ValueError("system message must be first")
        out.append({"role": role, "content": str(content)})
    return out


def _render_plain(messages: List[Dict], add_generation_prompt: bool) -> str:
    parts = [f"{m['role']}: {m['content']}\n" for m in messages]
    if add_generation_prompt:
        parts.append("assistant:")
    return "".join(parts)


def _render_llama2(messages: List[Dict], add_generation_prompt: bool) -> str:
    """The llama-2-chat format: alternating [INST] user [/INST] assistant
    blocks; the system prompt rides inside the first [INST] block."""
    msgs = list(messages)
    system = None
    if msgs and msgs[0]["role"] == "system":
        system = msgs.pop(0)["content"]
    parts = []
    expect: Role = "user"
    for m in msgs:
        if m["role"] != expect:
            raise ValueError(
                "llama2 template needs strictly alternating user/assistant "
                f"turns; got {m['role']!r} where {expect!r} was expected")
        if m["role"] == "user":
            content = m["content"]
            if system is not None:
                content = f"<<SYS>>\n{system}\n<</SYS>>\n\n{content}"
                system = None
            parts.append(f"[INST] {content} [/INST]")
            expect = "assistant"
        else:
            parts.append(f" {m['content']} ")
            expect = "user"
    if expect != "assistant":
        raise ValueError("llama2 template: conversation must end on a user "
                         "turn (the model speaks next)")
    # Generation cue is implicit: the rendering ends right after [/INST].
    del add_generation_prompt
    return "".join(parts)


def _render_chatml(messages: List[Dict], add_generation_prompt: bool) -> str:
    parts = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
             for m in messages]
    if add_generation_prompt:
        parts.append("<|im_start|>assistant\n")
    return "".join(parts)


TEMPLATES = {
    "plain": _render_plain,
    "llama2": _render_llama2,
    "chatml": _render_chatml,
}


def render_chat(messages: List[Dict], template: str = "plain",
                add_generation_prompt: bool = True) -> str:
    """Render an OpenAI-style messages list to a prompt string.

    Raises ValueError on malformed messages or an unknown template name —
    the server maps that to HTTP 400."""
    if template not in TEMPLATES:
        raise ValueError(f"unknown chat template {template!r}; "
                         f"available: {sorted(TEMPLATES)}")
    return TEMPLATES[template](_validate(messages), add_generation_prompt)


def stop_strings(template: str) -> Optional[List[str]]:
    """Template-specific stop STRINGS (the generation has left its turn when
    one appears).  Token-id stops (bos/eos) are the engine's job; these are
    for host-side truncation of templates whose turn delimiters are plain
    text in this vocab."""
    return {
        "plain": ["\nuser:", "\nsystem:"],
        "llama2": ["[INST]"],
        "chatml": ["<|im_end|>"],
    }.get(template)


def truncate_at_stop(text: str, stops: Optional[List[str]]) -> str:
    """Cut ``text`` at the earliest occurrence of any stop string."""
    if not stops:
        return text
    cut = len(text)
    for s in stops:
        i = text.find(s)
        if i != -1:
            cut = min(cut, i)
    return text[:cut]
