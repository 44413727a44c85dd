"""QA-prompt matcher: MUSIC-AVQA question template -> declarative prompt.

This package's own copy of ``qa_tiger_tpu/data/prompts.py``: the
reference's 33-template matcher (src/prompt_matcher.py:1-170) as a data
table, with its semantics kept exactly, including two reference quirks:

- template values are cleaned by stripping quotes/brackets/ALL spaces before
  the comma split, so multi-word values concatenate ("acoustic guitar" ->
  "acousticguitar"),
- an unmatched question returns the single character "e" (the reference sets
  ``qa_prompt = 'error!'`` then returns ``qa_prompt[0]``).
"""
from __future__ import annotations

# template -> (sentence format, indices into the cleaned templ_values list).
# Format slots {0},{1},... are filled positionally from the listed indices
# (negative indices address from the end, as the reference does with [-1]).
PROMPT_TABLE: dict[str, tuple[str, tuple[int, ...]]] = {
    "Is this sound from the instrument in the video?":
        ("The sound is from the instrument in the video.", ()),
    "Is the <Object> in the video always playing?":
        ("The {0} is not playing in this video.", (0,)),
    "Is there a voiceover?":
        ("There are sounds other than musical instruments in the video.", ()),
    "How many instruments are sounding in the video?":
        ("There are musical instruments playing in the video.", ()),
    "How many types of musical instruments sound in the video?":
        ("There are musical instruments playing in the video.", ()),
    "How many instruments in the video did not sound from beginning to end?":
        ("The instrument is not playing in the video.", ()),
    "How many sounding <Object> in the video?":
        ("The {0} is playing in this video.", (0,)),
    "Where is the <LL> instrument?":
        ("The sounds of musical instruments in the video are different.", ()),
    "Is the <FL> sound coming from the <LR> instrument?":
        ("The instruments in the video are not sounding simultaneously.", ()),
    "Which is the musical instrument that sounds at the same time as the "
    "<Object>?":
        ("The {0} is playing in this video.", (0,)),
    "What is the <LR> instrument of the <FL> sounding instrument?":
        ("There are musical instruments on the {0} that are not being "
         "played.", (-1,)),
    "Is the instrument on the <LR> more rhythmic than the instrument on the "
    "<LR>?":
        ("Inconsistent rhythmic sense of instrumental performance in the "
         "video.", ()),
    "Is the instrument on the <LR> louder than the instrument on the <LR>?":
        ("The sounds of musical instruments in the video are different.", ()),
    "Is the <Object> on the <LR> more rhythmic than the <Object> on the "
    "<LR>?":
        ("The {0} on the {1} plays a different rhythm than the {2} on the "
         "{3}.", (0, 1, 2, -1)),
    "Is the <Object> on the <LR> louder than the <Object> on the <LR>?":
        ("The {0} on the {1} and the {2} on the {3} produce different "
         "volumes of sound.", (0, 1, 2, -1)),
    "Where is the <FL> sounding instrument?":
        ("The instruments in the video do not sound simultaneously.", ()),
    "Which <Object> makes the sound <FL>?":
        ("The {0} in the video are not sounding at the same time.", (0,)),
    "What is the <TH> instrument that comes in?":
        ("There are musical instruments playing in the video.", ()),
    "Which instrument makes sounds <BA> the <Object>?":
        ("The {0} is playing in this video.", (-1,)),
    "Is there a <Object> in the entire video?":
        ("The {0} is not in this video.", (0,)),
    "Are there <Object> and <Object> instruments in the video?":
        ("There are instruments other than {0} or {1} in this video.",
         (0, -1)),
    "How many types of musical instruments appeared in the entire video?":
        ("There are musical instruments playing in the video.", ()),
    "How many <Object> are in the entire video?":
        ("The {0} is in this video.", (0,)),
    "Where is the performance?":
        ("There are musical instruments playing in the video.", ()),
    "What is the instrument on the <LR> of <Object>?":
        ("There is a musical instrument on the {0} side of the {1}.",
         (0, -1)),
    "What kind of musical instrument is it?":
        ("There are musical instruments playing in the video.", ()),
    "What kind of instrument is the <LRer> instrument?":
        ("There are musical instruments playing in the video.", ()),
    "Is there a <Object> sound?":
        ("There are sounds of instruments other than the {0} in the video.",
         (0,)),
    "Are there <Object> and <Object> sound?":
        ("There are sounds of instruments other than the {0} or the {1} in "
         "the video.", (0, -1)),
    "How many musical instruments were heard throughout the video?":
        ("There are musical instruments playing in the video.", ()),
    "Is the <Object> more rhythmic than the <Object>?":
        ("The {0} and {1} have different rhythms in the video.", (0, -1)),
    "Is the <Object> louder than the <Object>?":
        ("The {0} and {1} have different sounds in the video.", (0, -1)),
    "Is the <Object> playing longer than the <Object>?":
        ("The {0} and {1} are not played at the same time in the video.",
         (0, -1)),
}


def clean_templ_values(templ_values: str) -> list[str]:
    """Reference cleaning: strip quotes/brackets/spaces, split on commas."""
    cleaned = (str(templ_values).replace('"', "").replace("[", "")
               .replace("]", "").replace(" ", ""))
    return cleaned.split(",")


def match_prompt(question_content: str, templ_values: str) -> str:
    entry = PROMPT_TABLE.get(question_content)
    if entry is None:
        return "e"  # reference fallback: 'error!'[0]
    fmt, indices = entry
    values = clean_templ_values(templ_values)
    slots = [values[i] for i in indices]
    return fmt.format(*slots)
